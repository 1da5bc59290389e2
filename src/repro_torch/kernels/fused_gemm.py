"""Fused GEMM + Group Combine H (paper Alg. 2, stages 3-4), and the plain
tiled GEMM: CUDA wrappers.

Replaces the Pallas TPU kernels ``fused_gemm_combine_h`` and
``batched_fused_gemm_combine_h`` (``src/repro/kernels/fused_gemm.py``). One
CUDA kernel, ``csrc/fused_gemm.cu``, serves both: its grid carries the
group, with G = 1 for the 2-D form, and a shared ``bt`` has group stride 0.
On the H100 it is bound by bytes at the served shapes (a stream over B̃).
The Pallas design keeps R f32 accumulators per output tile, which does not
fit a Hopper SM for high-R schemes; this kernel finishes one H_r at a time
and folds it into the m*n output accumulators (Combine H is linear), so H
never reaches memory and every scheme up to s555 gets a tile. bf16 operands
run on the tensor cores through a cp.async ring, and where the output tiles
alone leave the card idle (decode rows) the (rank, K) reduction is split
across blocks and summed by a second, fixed-order pass
(``tuning.plan_fused_tc``); f32 operands run the SIMT kernel
(``tuning.plan_fused_gemm_blocks``), since TF32 would not meet f32 accuracy.

``tiled_matmul`` replaces the Pallas ``tiled_matmul``, the non-LCMA
baseline the autotuner times for FLOPS_x (``csrc/tiled_matmul.cu``). It has
two routes, chosen before the launch by ``tuning.tiled_route``: bf16
operands that TMA can address run on the tensor cores (TMA ring + wgmma,
``tuning.plan_tiled_wgmma``, K split across blocks where the tiles alone
leave the card idle), the rest (f32, unaligned bf16) on the SIMT kernel
(``tuning.plan_tiled_matmul_blocks``). The wrapper counts launches per
route in ``tiled_matmul.routes``.

A tensor on the CPU (or meta) takes the plain version (``ref.fused_gemm_combine_h_ref``,
``ref.tiled_matmul_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import build, ref
from .group_combine import coeff_table, refuse_grad
from .tuning import (plan_fused_gemm_blocks, plan_fused_tc, plan_tiled_matmul_blocks,
                     plan_tiled_wgmma, tiled_route)

__all__ = ["fused_gemm_combine_h", "batched_fused_gemm_combine_h", "tiled_matmul"]

_DTYPES = (torch.float32, torch.bfloat16)


def _check(at, bt, w, out_dtype, at_ndim, what):
    refuse_grad(what, at, bt)
    R, m, n = w.shape
    if at.ndim != at_ndim or bt.ndim not in (3, at_ndim):
        raise ValueError(f"{what}: unexpected ranks {tuple(at.shape)} x "
                         f"{tuple(bt.shape)}")
    if at.shape[-3] != R or bt.shape[-3] != R or at.shape[-1] != bt.shape[-2]:
        raise ValueError(f"{what}: shapes do not conform: {tuple(at.shape)} x "
                         f"{tuple(bt.shape)} with W {tuple(w.shape)}")
    if bt.ndim == at_ndim and at_ndim == 4 and bt.shape[0] != at.shape[0]:
        raise ValueError(f"{what}: group sizes differ: {tuple(at.shape)} x "
                         f"{tuple(bt.shape)}")
    if at.dtype not in _DTYPES or bt.dtype != at.dtype or out_dtype not in _DTYPES:
        raise TypeError(f"{what}: dtypes {at.dtype}/{bt.dtype} -> {out_dtype} "
                        f"not supported (float32 and bfloat16 are)")
    if at.device != bt.device or at.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{what}: operands on {at.device} and {bt.device}")
    if at.device.type == "cuda" and not (at.is_contiguous() and bt.is_contiguous()):
        raise ValueError(f"{what}: the CUDA kernel needs contiguous operands")


def _launch(at4: torch.Tensor, bt: torch.Tensor, w: np.ndarray,
            out_dtype: torch.dtype) -> torch.Tensor:
    """bf16 operands go to the tensor-core kernel (split at decode, with an
    f32 workspace for the partials), f32 ones to the SIMT kernel: the C
    entry point dispatches on the dtype."""
    R, m, n = w.shape
    G, _, X, Y = at4.shape
    Z = bt.shape[-1]
    out = torch.empty((G, m, n, X, Z), dtype=out_dtype, device=at4.device)
    if at4.dtype == torch.bfloat16:
        plan = plan_fused_tc(G, X, Y, Z, R, m, n, shared_b=bt.ndim == 3)
        bx, bz, splits, smem = plan.bx, plan.bz, plan.splits, plan.smem_bytes
    else:
        (bx, bz, _), splits, smem = plan_fused_gemm_blocks(X, m, n), 1, 0
    ws = (torch.empty((splits, G, m * n, X, Z), dtype=torch.float32, device=at4.device)
          if splits > 1 else None)
    vec = int(Y % 8 == 0 and Z % 8 == 0 and at4.data_ptr() % 16 == 0
              and bt.data_ptr() % 16 == 0)
    codes = build.DTYPE_CODES
    lib = build.library("fused_gemm")
    err = lib.falcon_fused_gemm_combine_h(
        at4.device.index, at4.data_ptr(), bt.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        coeff_table(w, at4.device).data_ptr(),
        codes[str(at4.dtype).removeprefix("torch.")],
        codes[str(out_dtype).removeprefix("torch.")],
        G, R, m * n, X, Y, Z, R * Y * Z if bt.ndim == 4 else 0, vec, bx, bz, splits,
        smem, torch.cuda.current_stream(at4.device).cuda_stream)
    build.check(lib, err, "fused_gemm_combine_h")
    return out


def fused_gemm_combine_h(at: torch.Tensor, bt: torch.Tensor, w: np.ndarray,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(R, X, Y) x (R, Y, Z) --W--> C parts (m, n, X, Z) in ``out_dtype``."""
    out_dtype = out_dtype or at.dtype
    _check(at, bt, w, out_dtype, 3, "fused_gemm_combine_h")
    if at.device.type != "cuda":
        return ref.fused_gemm_combine_h_ref(at, bt, w, out_dtype)
    out = _launch(at[None], bt, w, out_dtype)[0]
    fused_gemm_combine_h.launches += 1
    fused_gemm_combine_h.shapes[(tuple(at.shape), tuple(bt.shape))] += 1
    return out


def batched_fused_gemm_combine_h(at: torch.Tensor, bt: torch.Tensor,
                                 w: np.ndarray,
                                 out_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """Grouped: (G, R, X, Y) x bt --W--> (G, m, n, X, Z).

    ``bt`` is (G, R, Y, Z) per group or (R, Y, Z) shared by the group (the
    hoisted Combine B, read with group stride 0, never replicated).
    """
    out_dtype = out_dtype or at.dtype
    _check(at, bt, w, out_dtype, 4, "batched_fused_gemm_combine_h")
    if at.device.type != "cuda":
        bt_b = bt if bt.ndim == 4 else bt[None]
        return ref.fused_gemm_combine_h_ref(at, bt_b, w, out_dtype)
    out = _launch(at, bt, w, out_dtype)
    batched_fused_gemm_combine_h.launches += 1
    batched_fused_gemm_combine_h.shapes[(tuple(at.shape), tuple(bt.shape))] += 1
    return out


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``out_dtype`` (default ``a``'s), summed
    in f32 and rounded once. Any M, K, N: the kernel masks its own edges."""
    out_dtype = out_dtype or a.dtype
    refuse_grad("tiled_matmul", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: shapes do not conform: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype or out_dtype not in _DTYPES:
        raise TypeError(f"tiled_matmul: dtypes {a.dtype}/{b.dtype} -> {out_dtype} "
                        f"not supported (float32 and bfloat16 are)")
    if a.device != b.device or a.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"tiled_matmul: operands on {a.device} and {b.device}")
    if a.device.type != "cuda":
        return ref.tiled_matmul_ref(a, b, out_dtype)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul: the CUDA kernel needs contiguous operands")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    codes = build.DTYPE_CODES
    out_code = codes[str(out_dtype).removeprefix("torch.")]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = build.library("tiled_matmul")
    route = tiled_route(str(a.dtype).removeprefix("torch."), K, N, a.data_ptr(), b.data_ptr())
    if route == "wgmma":
        plan = plan_tiled_wgmma(M, K, N)
        ws = (torch.empty((plan.splits, M, N), dtype=torch.float32, device=a.device)
              if plan.splits > 1 else None)
        err = lib.falcon_tiled_matmul_wgmma(
            a.device.index, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, out_code, M, K, N,
            plan.bm, plan.bn, plan.splits, plan.smem_bytes, stream)
    else:
        bm, bn, _ = plan_tiled_matmul_blocks(M, N)
        err = lib.falcon_tiled_matmul(a.device.index, a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), codes[str(a.dtype).removeprefix("torch.")],
                                      out_code, M, K, N, bm, bn, stream)
    build.check(lib, err, f"tiled_matmul ({route})")
    tiled_matmul.launches += 1
    tiled_matmul.routes[route] += 1
    return out


# Calls that launched the fused kernel, counted by the wrapper; a bf16 call
# with splits > 1 also launches the reduce pass, which is not counted.
fused_gemm_combine_h.launches = 0
batched_fused_gemm_combine_h.launches = 0
# the same launches by operand shapes (at, bt): a per-group B̃ is 4-D
fused_gemm_combine_h.shapes = Counter()
batched_fused_gemm_combine_h.shapes = Counter()
tiled_matmul.launches = 0
tiled_matmul.routes = {"wgmma": 0, "simt": 0}   # the same launches, by route
