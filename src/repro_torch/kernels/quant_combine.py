"""Quantization fused into Group Combine (paper §IV-C): CUDA wrappers.

Replace the Pallas TPU kernels ``group_combine_quant`` and
``fused_gemm_combine_h_quant`` (``src/repro/kernels/quant_combine.py``), both
in ``csrc/quant_combine.cu``:

* ``group_combine_quant`` — Combine A in f32 and symmetric int8
  quantization with one f32 scale per (rank, row, K-block of ``by``
  columns), in one pass over A. Bound by bytes on the H100, so a stream of
  16-byte loads with the K-block's absmax taken in registers across its
  lanes; where ``by`` or the input's pointer rules out 16-byte access, the
  same kernel moves single elements (``launch_plan``: the route, decided
  before the launch, counted in ``group_combine_quant.routes``).
* ``fused_gemm_combine_h_quant`` — int8 x int8 products on the tensor
  cores, summed exactly in int32 per K-block, dequantized by the row and
  column scales, then Combine H from registers: H never reaches memory and
  C is written once in the io dtype. Bound by bytes at serving M (the int8
  B̃q stream); at decode the reduction is split across blocks on K-block
  boundaries (``tuning.plan_fused_tc``) and summed by a second pass.

``quantize_b_blockwise`` (offline Combine B + int8 of a static weight) has
no Pallas kernel of its own: it is the ``group_combine`` kernel at the
weight's dtype, then the blockwise absmax and rounding in plain PyTorch.

A tensor on the CPU (or the shape-only ``meta`` device) takes the plain
version (``ref.*_quant_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch.analysis.stability import max_safe_accum_depth
from . import build, ref
from .group_combine import coeff_table, group_combine, refuse_grad
from .tuning import QuantCombinePlan, plan_fused_tc, plan_quant_combine, scale_block

__all__ = ["group_combine_quant", "fused_gemm_combine_h_quant",
           "quantize_b_blockwise", "scale_block", "launch_plan"]

_DTYPES = (torch.float32, torch.bfloat16)


def _on_card(*ts: torch.Tensor, what: str) -> bool:
    """True for CUDA operands (contiguous, one device), False for CPU or meta
    ones."""
    refuse_grad(what, *ts)
    devs = {t.device for t in ts}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}")
    if ts[0].device.type != "cuda":
        return False
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: the CUDA kernel needs contiguous operands")
    return True


def _code(dtype: torch.dtype) -> int:
    return build.DTYPE_CODES[str(dtype).removeprefix("torch.")]


def launch_plan(x: torch.Tensor, coeff: np.ndarray, by: int) -> QuantCombinePlan:
    """The plan ``group_combine_quant`` launches for ``x`` (d1*X, d2*Y)
    under ``coeff`` with K-block ``by``: the vector route needs ``x``
    16-byte aligned (the outputs are fresh allocations)."""
    _, d1, d2 = coeff.shape
    return plan_quant_combine(x.shape[0] // d1, x.shape[1] // d2, coeff, x.element_size(),
                              by, x.data_ptr() % 16 == 0)


def group_combine_quant(x: torch.Tensor, coeff: np.ndarray,
                        by: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantizing Group Combine of ``x`` (d1*X, d2*Y) -> (q int8 (R, X, Y),
    scales f32 (R, X, Y/by)). ``by`` must divide Y; padding is the
    caller's (``repro_torch.kernels.ops``)."""
    R, d1, d2 = coeff.shape
    if x.ndim != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"group_combine_quant: expected a 2-D float32/bfloat16 "
                         f"input, got {tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if M % d1 or K % d2 or by < 1 or (K // d2) % by:
        raise ValueError(f"group_combine_quant: input {tuple(x.shape)} is not "
                         f"divisible by the grid ({d1}, {d2}) and K-block {by}")
    if not _on_card(x, what="group_combine_quant"):
        return ref.group_combine_quant_ref(x, coeff, by)
    X, Y = M // d1, K // d2
    plan = launch_plan(x, coeff, by)
    q = torch.empty((R, X, Y), dtype=torch.int8, device=x.device)
    s = torch.empty((R, X, Y // by), dtype=torch.float32, device=x.device)
    tab = coeff_table(coeff, x.device)
    lib = build.library("quant_combine")
    err = lib.falcon_group_combine_quant(
        x.device.index, x.data_ptr(), q.data_ptr(), s.data_ptr(), tab.data_ptr(),
        tab.numel(), _code(x.dtype), R, d1, d2, X, Y, by, plan.vec, plan.lanes,
        plan.threads, plan.splits, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "group_combine_quant")
    group_combine_quant.launches += 1
    group_combine_quant.routes[plan.route] += 1
    group_combine_quant.shapes[(tuple(x.shape), by)] += 1
    return q, s


def fused_gemm_combine_h_quant(aq: torch.Tensor, a_scales: torch.Tensor,
                               bq: torch.Tensor, b_scales: torch.Tensor,
                               w: np.ndarray,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 fused LCMA GEMM + Combine H with (1 x K-block) scaling.

    aq (R, X, Y) int8, a_scales (R, X, Yb), bq (R, Y, Z) int8, b_scales
    (R, Yb, Z) -> C parts (m, n, X, Z) in ``out_dtype``. The K-block size
    ``by = Y // Yb`` is the depth of each int32 sum, so it must stay within
    ``max_safe_accum_depth(32)``.
    """
    R, m, n = w.shape
    if aq.ndim != 3 or bq.ndim != 3 or aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise TypeError(f"fused_gemm_combine_h_quant: expected int8 (R, X, Y) and "
                        f"(R, Y, Z), got {aq.dtype} {tuple(aq.shape)} and "
                        f"{bq.dtype} {tuple(bq.shape)}")
    _, X, Y = aq.shape
    Z = bq.shape[2]
    Yb = a_scales.shape[-1]
    if (aq.shape[0] != R or bq.shape[:2] != (R, Y) or Yb < 1 or Y % Yb
            or tuple(a_scales.shape) != (R, X, Yb) or tuple(b_scales.shape) != (R, Yb, Z)):
        raise ValueError(f"fused_gemm_combine_h_quant: shapes do not conform: "
                         f"{tuple(aq.shape)} / {tuple(a_scales.shape)} x "
                         f"{tuple(bq.shape)} / {tuple(b_scales.shape)} with W "
                         f"{tuple(w.shape)}")
    if a_scales.dtype != torch.float32 or b_scales.dtype != torch.float32 \
            or out_dtype not in _DTYPES:
        raise TypeError(f"fused_gemm_combine_h_quant: f32 scales and a float32/"
                        f"bfloat16 output needed, got {a_scales.dtype}/"
                        f"{b_scales.dtype} -> {out_dtype}")
    by = Y // Yb
    # The reference's static overflow guard: `by` int8 x int8 products are
    # summed in an int32 before dequantizing, worst case by * 127**2.
    if by > max_safe_accum_depth(32):
        raise ValueError(
            f"fused_gemm_combine_h_quant: K-block depth {by} overflows the "
            f"int32 accumulator (worst |sum| = {by} * 127^2); max safe depth "
            f"is {max_safe_accum_depth(32)} — use a smaller scale block")
    if not _on_card(aq, a_scales, bq, b_scales, what="fused_gemm_combine_h_quant"):
        return ref.fused_gemm_combine_h_quant_ref(aq, a_scales, bq, b_scales, w, out_dtype)
    plan = plan_fused_tc(1, X, Y, Z, R, m, n, by=by)
    vec = int(Y % 16 == 0 and Z % 16 == 0 and by % 16 == 0
              and aq.data_ptr() % 16 == 0 and bq.data_ptr() % 16 == 0)
    out = torch.empty((m, n, X, Z), dtype=out_dtype, device=aq.device)
    ws = (torch.empty((plan.splits, m * n, X, Z), dtype=torch.float32, device=aq.device)
          if plan.splits > 1 else None)
    lib = build.library("quant_combine")
    err = lib.falcon_fused_gemm_quant(
        aq.device.index, aq.data_ptr(), a_scales.data_ptr(), bq.data_ptr(),
        b_scales.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
        coeff_table(w, aq.device).data_ptr(), _code(out_dtype), R, m * n, X, Y, Z, by,
        vec, plan.bx, plan.bz, plan.splits, plan.smem_bytes,
        torch.cuda.current_stream(aq.device).cuda_stream)
    build.check(lib, err, "fused_gemm_combine_h_quant")
    fused_gemm_combine_h_quant.launches += 1
    fused_gemm_combine_h_quant.shapes[(tuple(aq.shape), tuple(bq.shape), by)] += 1
    return out


def quantize_b_blockwise(b: torch.Tensor, coeff: np.ndarray,
                         by: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline Combine B + quantization of a static weight (K, N) whose
    dimensions divide the grid: (bq int8 (R, Y, Z), b_scales f32 (R, Y/by,
    Z)) with per-(K-block, column) scales, as ``fused_gemm_combine_h_quant``
    reads them. Combine B is the ``group_combine`` kernel in ``b``'s dtype."""
    return ref.quantize_blocks_ref(group_combine(b, coeff), by)


# Calls that launched the kernel, counted by the wrapper; a fused call with
# splits > 1 also launches the reduce pass, which is not counted.
group_combine_quant.launches = 0
group_combine_quant.routes = {"vector": 0, "scalar": 0}   # the same launches, by route
group_combine_quant.shapes = Counter()      # by (input shape, K-block)
fused_gemm_combine_h_quant.launches = 0
fused_gemm_combine_h_quant.shapes = Counter()   # by (Ãq shape, B̃q shape, K-block)
