"""Drive the PyTorch/CUDA port of FalconGEMM on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each: device, build (nvcc for sm_90a from
src/repro_torch/csrc, one process per source, all at once; then ptxas's
registers, shared memory and spills of the tiled GEMM's and the Group
Combine's kernels), every kernel entry
point against its plain PyTorch version (six schemes x f32/bf16 x ragged
shapes, ragged decode rows whose reduction the tensor-core fused kernels split
across blocks, and every shape the served model gives the kernel; the int8
kernels likewise; the tiled GEMM at ragged, unaligned, probe and decode
shapes, each case's route asserted: the tensor cores for aligned bf16, the
SIMT kernel for f32, ragged and misaligned operands), the ops pipelines
against torch.matmul at granite shapes, kernel times (CUDA events around 50
back-to-back launches, or the profiler's device time where the wrapper's host
cost exceeds the kernel's; each line carries the call's plan: tile, ring
stages and splits, or the Group Combine's vector width and block), model parity (2 layers at
full width, f32, strassen vs gemm), serving full granite_3_2b (40 layers, bf16,
4 requests x 16 tokens) three ways with every kernel's launch count: forced
strassen, int8 in auto mode (``--quant``) and int8 with forced strassen, each
int8 run held to the fp run on the same weights; what auto mode decides on the
h100_sxm profile; then the calibration path: ``repro_torch.tools.tune``
measures the card (through the tiled GEMM), the data-sheet and calibrated
decisions side by side, and granite served in auto mode under the calibrated
profile with the warmed plan cache, held to the fp auto run.
Any failure raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is missing. Needs a CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.api as falcon  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import algorithms as alg, plan_cache  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.lcma import LCMA  # noqa: E402
from repro_torch.kernels import build, ops, ref, tuning  # noqa: E402
from repro_torch.kernels.group_combine import launch_plan  # noqa: E402
from repro_torch.kernels.quant_combine import scale_block  # noqa: E402
from repro_torch.launch.serve import run_oneshot  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DEV = "cuda"
# Kernel vs plain version, error normalized by max(1, max|plain|). f32: the
# same f32 arithmetic in another summation order. bf16: both round one f32
# value once, so they differ by at most one bf16 ulp (2**-7 relative).
TOL = {torch.float32: {"combine": 1e-5, "fused": 1e-4},
       torch.bfloat16: {"combine": 1e-2, "fused": 1e-2}}
# int8 kernels vs plain versions. Quant Group Combine: the same f32 sums and
# scale, so q may differ by one step at most and the scales by 1e-6
# relative. Fused int8: exact int sums, the same dequantize and Combine H
# order; f32 out 1e-5 normalized, bf16 out one bf16 ulp.
QUANT_TOL = {"dq": 1, "scale": 1e-6, torch.float32: 1e-5, torch.bfloat16: 1e-2}
OPS_TOL = 1e-4          # f32 LCMA pipeline vs torch.matmul, normalized
OPS_QUANT_TOL = 0.02    # f32 int8 LCMA vs torch.matmul, relative Frobenius
PARITY_TOL = 1e-3       # 2-layer f32 prefill logits, strassen vs gemm, normalized
QUALITY_TOL = 0.15      # int8 vs fp serve logits, prefix-matched relative

SOURCES = {"group_combine": "src/repro_torch/csrc/group_combine.cu",
           "batched_group_combine": "src/repro_torch/csrc/group_combine.cu",
           "fused_gemm_combine_h": "src/repro_torch/csrc/fused_gemm.cu",
           "batched_fused_gemm_combine_h": "src/repro_torch/csrc/fused_gemm.cu",
           "group_combine_quant": "src/repro_torch/csrc/quant_combine.cu",
           "fused_gemm_combine_h_quant": "src/repro_torch/csrc/quant_combine.cu",
           "tiled_matmul": "src/repro_torch/csrc/tiled_matmul.cu"}
REPLACES = {"group_combine": "src/repro/kernels/group_combine.py:47",
            "batched_group_combine": "src/repro/kernels/group_combine.py:111",
            "fused_gemm_combine_h": "src/repro/kernels/fused_gemm.py:71",
            "batched_fused_gemm_combine_h": "src/repro/kernels/fused_gemm.py:147",
            "group_combine_quant": "src/repro/kernels/quant_combine.py:59",
            "fused_gemm_combine_h_quant": "src/repro/kernels/quant_combine.py:125",
            "tiled_matmul": "src/repro/kernels/fused_gemm.py:222"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def mag2_scheme() -> LCMA:
    """<2,2,2>;14 with |c| up to 3: <1,1,1>;2 (C = (2A)(2B) - 3AB) x Strassen."""
    l111 = LCMA("mag2-111", 1, 1, 1, 2, np.array([[[2]], [[1]]], np.int8),
                np.array([[[2]], [[1]]], np.int8), np.array([[[1]], [[-3]]], np.int8))
    return alg.tensor_product(l111, alg.strassen(), "mag2-222")


def schemes() -> list[LCMA]:
    return [alg.get(n) for n in ("strassen", "strassen-winograd", "laderman",
                                 "s444", "s555")] + [mag2_scheme()]


def randn(*shape, dtype=torch.float32, gen=None):
    return torch.randn(shape, device=DEV, generator=gen).to(dtype)


def err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max|want|))."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(1.0, want.float().abs().max().item())


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Cases: each returns (kernel call, plain call) on the same inputs
# ---------------------------------------------------------------------------

def combine_case(l, dtype, shape, which, gen, grouped):
    coeff = l.U if which == "U" else l.V
    d1, d2 = coeff.shape[1:]
    rows, cols = shape
    x = randn(*(((3,) if grouped else ()) + (d1 * cdiv(rows, d1), d2 * cdiv(cols, d2))),
              dtype=dtype, gen=gen)
    k = kernels.batched_group_combine if grouped else kernels.group_combine
    return (lambda: k(x, coeff),
            lambda: ref.group_combine_ref(ref.split_blocks(x, d1, d2), coeff))


def fused_case(l, dtype, X, Y, Z, gen, groups=None, shared=False, split=False):
    """``split``: a case the bf16 planner must split (S > 1), checked here."""
    lead = () if groups is None else (groups,)
    if split and dtype == torch.bfloat16:
        plan = tuning.plan_fused_tc(groups or 1, X, Y, Z, l.R, l.m, l.n, shared_b=shared)
        if plan.splits < 2:
            raise AssertionError(f"fused case {(groups, X, Y, Z)} under {l.name} is not "
                                 f"split: {plan}")
    at = randn(*lead, l.R, X, Y, dtype=dtype, gen=gen)
    bt = randn(*(() if shared else lead), l.R, Y, Z, dtype=dtype, gen=gen)
    if groups is None:
        return (lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
                lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W))
    bt_ref = bt[None] if shared else bt
    return (lambda: kernels.batched_fused_gemm_combine_h(at, bt, l.W),
            lambda: ref.fused_gemm_combine_h_ref(at, bt_ref, l.W))


# The served model's logical products (M, K, N): prefill M = 4 x 64 rows,
# decode M = 4; granite's projections (2048 -> 2048 / 512 / 8192, 8192 ->
# 2048) and the tied LM head (2048 -> 49408). Attention: B*H = 128 groups,
# 64 queries at prefill and 1 at decode, against 80 cached keys.
PROJ = [(M_, K, N) for M_ in (256, 4)
        for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 49408))]
ATTN = [(64, 64, 80), (64, 80, 64), (1, 64, 80), (1, 80, 64)]
# The tune phase's probes (M, K, N): the autotuner runs Group Combine A and
# B, the fused kernel, the quant Group Combine and the LCMA pipeline on each.
PROBES = [(256, 2048, 8192), (256, 8192, 2048), (4096, 4096, 4096)]


def kernel_cases(l, dtype, gen):
    """Generators of (kernel call, plain call) per entry point: ragged shapes,
    then every shape the main path gives the kernel under scheme ``l`` (the
    served model's products and the tune phase's probes). Lazy, so only one
    case's tensors live at a time."""
    g = lambda M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
    products = sorted(set(PROJ + PROBES))
    weights = sorted({(K, N) for _, K, N in products})
    return {
        "group_combine": itertools.chain(
            [combine_case(l, dtype, (37 * l.m, 53 * l.k), "U", gen, False),
             combine_case(l, dtype, (53 * l.k, 29 * l.n), "V", gen, False)],
            (combine_case(l, dtype, (M_, K), "U", gen, False)
             for M_, K in sorted({(M_, K) for M_, K, _ in products})),
            # Combine B: offline for the projections, each step for the LM
            # head, each call of the pipeline probe
            (combine_case(l, dtype, kn, "V", gen, False) for kn in weights)),
        "batched_group_combine": itertools.chain(
            [combine_case(l, dtype, (19 * l.m, 23 * l.k), "U", gen, True)],
            (combine_case(l, dtype, (M_, K), "U", gen, True) for M_, K, _ in ATTN),
            (combine_case(l, dtype, (K, N), "V", gen, True) for _, K, N in ATTN[:2])),
        "fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 37, 53, 45, gen),
             # ragged decode rows, the reduction split across blocks (bf16)
             fused_case(l, dtype, 3, 301, 45, gen, split=True)],
            (fused_case(l, dtype, *g(*mkn), gen) for mkn in products)),
        "batched_fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 19, 23, 21, gen, groups=3),
             fused_case(l, dtype, 19, 23, 21, gen, groups=3, shared=True),
             fused_case(l, dtype, 2, 333, 45, gen, groups=3, shared=True, split=True),
             fused_case(l, dtype, *g(4, 2048, 2048), gen, groups=2, shared=True)],
            (fused_case(l, dtype, *g(*mkn), gen, groups=128) for mkn in ATTN)),
    }


def phase_kernels() -> None:
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst = {}
    n = 0
    for l in schemes():
        for dtype in (torch.float32, torch.bfloat16):
            for name, fns in kernel_cases(l, dtype, gen).items():
                kind = "fused" if "fused" in name else "combine"
                tol = TOL[dtype][kind]
                for kfn, pfn in fns:
                    got = kfn()
                    torch.cuda.synchronize()
                    want = pfn()
                    if got.shape != want.shape or got.dtype != want.dtype:
                        raise AssertionError(f"{name}/{l.name}: {got.shape} {got.dtype} "
                                             f"vs plain {want.shape} {want.dtype}")
                    a, e = err(got, want)
                    n += 1
                    emit("kernel_case", kernel=name, scheme=l.name, dtype=str(dtype),
                         shape=list(got.shape), max_abs_err=a, err=e, tol=tol)
                    if not e <= tol:
                        raise AssertionError(f"{name}/{l.name}/{dtype}: error {e} > {tol}")
                    worst[name] = max(worst.get(name, 0.0), e)
    emit("kernels", cases=n, worst_err=worst)


def quant_combine_err(got, want) -> tuple[int, int, float]:
    """(max |q - q_plain| in int8 steps, number of such flips, max relative
    scale error) of the quant Group Combine against its plain version."""
    (q, s), (q0, s0) = got, want
    if q.shape != q0.shape or s.shape != s0.shape or q.dtype != torch.int8:
        raise AssertionError(f"group_combine_quant: {q.shape} {q.dtype} / {s.shape} vs "
                             f"plain {q0.shape} / {s0.shape}")
    dq = (q.int() - q0.int()).abs()
    return (int(dq.max().item()), int((dq > 0).sum().item()),
            ((s - s0).abs() / s0).max().item())


def check_quant_combine(what: str, got, want) -> tuple[int, int, float]:
    dq, flips, ds = quant_combine_err(got, want)
    if dq > QUANT_TOL["dq"] or not ds <= QUANT_TOL["scale"]:
        raise AssertionError(f"{what}: |dq| {dq} ({flips} flips), scale error {ds}")
    return dq, flips, ds


def quant_combine_case(l, dtype, X, Y, by, gen):
    x = randn(l.m * X, l.k * Y, dtype=dtype, gen=gen)
    return (lambda: kernels.group_combine_quant(x, l.U, by),
            lambda: ref.group_combine_quant_ref(x, l.U, by))


def fused_quant_case(l, X, Y, Z, by, out_dtype, gen):
    def i8(*shape):
        return torch.randint(-127, 128, shape, device=DEV, generator=gen, dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, device=DEV, generator=gen) * 0.02 + 1e-3

    aq, bq = i8(l.R, X, Y), i8(l.R, Y, Z)
    a_s, b_s = scales(l.R, X, Y // by), scales(l.R, Y // by, Z)
    return (lambda: kernels.fused_gemm_combine_h_quant(aq, a_s, bq, b_s, l.W,
                                                       out_dtype=out_dtype),
            lambda: ref.fused_gemm_combine_h_quant_ref(aq, a_s, bq, b_s, l.W, out_dtype))


# The products of the planned leaves (the LM head is never planned), at the
# prefill and decode M of the served model.
PROJ_PLANNED = [(M_, K, N) for M_, K, N in PROJ if N != 49408]


def phase_quant_kernels() -> None:
    """The two int8 kernels against their plain versions: every scheme, f32
    and bf16, a ragged shape and every shape a planned leaf gives them, and
    the quant Group Combine at the tune phase's probes (the scale block
    ``by`` as ``kernels.quant_combine.scale_block`` sets it)."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    worst = {"group_combine_quant": [0, 0, 0.0], "fused_gemm_combine_h_quant": {}}
    n = 0
    for l in schemes():
        g = lambda M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
        combine = [(37, 75, 25)] + [(X, Y, scale_block(Y)) for X, Y in sorted(
            {(cdiv(M_, l.m), cdiv(K, l.k)) for M_, K, _ in PROJ_PLANNED + PROBES})]
        # ragged, then ragged decode rows with a K-block that is no multiple
        # of 32, split across blocks (S > 1, checked), then the leaves' shapes
        fused = [(37, 75, 45, 25), (3, 300, 45, 100)] + [
            (*g(*mkn), scale_block(g(*mkn)[1])) for mkn in PROJ_PLANNED]
        if tuning.plan_fused_tc(1, 3, 300, 45, l.R, l.m, l.n, by=100).splits < 2:
            raise AssertionError(f"quant case (3, 300, 45, 100) under {l.name} is not split")
        for dtype in (torch.float32, torch.bfloat16):
            for X, Y, by in combine:
                kfn, pfn = quant_combine_case(l, dtype, X, Y, by, gen)
                got = kfn()
                torch.cuda.synchronize()
                dq, flips, ds = check_quant_combine(f"group_combine_quant/{l.name}/{dtype}",
                                                    got, pfn())
                n += 1
                emit("kernel_case", kernel="group_combine_quant", scheme=l.name,
                     dtype=str(dtype), X=X, Y=Y, by=by, max_dq=dq, flips=flips,
                     scale_err=ds, tol=[QUANT_TOL["dq"], QUANT_TOL["scale"]])
                w = worst["group_combine_quant"]
                w[:] = [max(w[0], dq), w[1] + flips, max(w[2], ds)]
            for X, Y, Z, by in fused:
                kfn, pfn = fused_quant_case(l, X, Y, Z, by, dtype, gen)
                got = kfn()
                torch.cuda.synchronize()
                want = pfn()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"fused_gemm_combine_h_quant/{l.name}: {got.shape} "
                                         f"{got.dtype} vs plain {want.shape} {want.dtype}")
                a, e = err(got, want)
                tol = QUANT_TOL[dtype]
                n += 1
                emit("kernel_case", kernel="fused_gemm_combine_h_quant", scheme=l.name,
                     dtype=str(dtype), X=X, Y=Y, Z=Z, by=by, max_abs_err=a, err=e, tol=tol)
                if not e <= tol:
                    raise AssertionError(f"fused_gemm_combine_h_quant/{l.name}/{dtype} "
                                         f"{(X, Y, Z, by)}: error {e} > {tol}")
                wf = worst["fused_gemm_combine_h_quant"]
                wf[str(dtype)] = max(wf.get(str(dtype), 0.0), e)
    emit("quant_kernels", cases=n, worst=worst)


# The tiled GEMM's cases (M, K, N): ragged, K unaligned for 16-byte loads in
# both dtypes, one tensor-core tile, aligned shapes with ragged tiles (M, K
# and N tails, a B box wholly outside the matrix, a split K with a tail), the
# autotuner's three probe shapes, and decode rows. The two ragged shapes have
# row strides TMA cannot address.
TILED_RAGGED = [(13, 23, 17), (64, 101, 72)]
TILED_SHAPES = [*TILED_RAGGED, (128, 64, 128), (200, 136, 264), (300, 1000, 520), *PROBES,
                (4, 2048, 8192)]


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data pointer is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def tiled_call(a, b, want_route: str, **kw) -> torch.Tensor:
    """``kernels.tiled_matmul(a, b)``, checked to have taken ``want_route``."""
    before = dict(kernels.tiled_matmul.routes)
    got = kernels.tiled_matmul(a, b, **kw)
    moved = {r: kernels.tiled_matmul.routes[r] - before[r] for r in before}
    if moved != {r: int(r == want_route) for r in before}:
        raise AssertionError(f"tiled_matmul {tuple(a.shape)} @ {tuple(b.shape)} {a.dtype}: "
                             f"routes {moved}, expected {want_route}")
    return got


def phase_tiled_kernels() -> None:
    """The tiled GEMM against its plain version in f32 and bf16, with the
    ``fused`` tolerance of ``TOL``: the same f32 sums in another order, and
    in bf16 one rounding of each. Aligned bf16 must take the tensor-core
    route (TMA + wgmma); f32, the ragged shapes and one aligned shape run
    from operands whose pointers are not 16-byte aligned must take the SIMT
    kernel."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    n, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(shape, False) for shape in TILED_SHAPES] + [((256, 512, 384), True)]
        for (M_, K, N), shift in cases:
            a, b = randn(M_, K, dtype=dtype, gen=gen), randn(K, N, dtype=dtype, gen=gen)
            if shift:
                a, b = misaligned(a), misaligned(b)
            route = ("wgmma" if dtype == torch.bfloat16 and not shift
                     and (M_, K, N) not in TILED_RAGGED else "simt")
            got = tiled_call(a, b, route)
            torch.cuda.synchronize()
            want = ref.tiled_matmul_ref(a, b)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"tiled_matmul: {got.shape} {got.dtype} vs plain "
                                     f"{want.shape} {want.dtype}")
            abs_err, e = err(got, want)
            tol = TOL[dtype]["fused"]
            n += 1
            emit("kernel_case", kernel="tiled_matmul", dtype=str(dtype), M=M_, K=K, N=N,
                 misaligned=shift, route=route, max_abs_err=abs_err, err=e, tol=tol)
            if not e <= tol:
                raise AssertionError(f"tiled_matmul {dtype} {(M_, K, N)}: error {e} > {tol}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), e)
            del a, b, got, want
    torch.cuda.empty_cache()
    emit("tiled_kernels", cases=n, worst_err=worst)


def phase_ops() -> None:
    gen = torch.Generator(device=DEV).manual_seed(2)
    l = alg.get("strassen")
    K = 2048
    for M_ in (256, 4):
        for N in (2048, 512, 8192, 49408):
            a = randn(M_, K, gen=gen)
            b = randn(K, N, gen=gen)
            a3 = randn(2, M_, K, gen=gen)
            b3 = randn(2, K, N, gen=gen)
            results = {
                "falcon_matmul": (ops.falcon_matmul(a, b, l), a @ b),
                "falcon_matmul_precombined": (
                    ops.falcon_matmul_precombined(a, falcon.precombine_weights(b, l), l, N), a @ b),
                "falcon_grouped_matmul": (ops.falcon_grouped_matmul(a3, b3, l), a3 @ b3),
                "falcon_grouped_matmul_shared": (ops.falcon_grouped_matmul(a3, b, l), a3 @ b),
                "falcon_grouped_matmul_precombined": (
                    ops.falcon_grouped_matmul_precombined(
                        a3, falcon.precombine_weights(b, l), l, N), a3 @ b),
            }
            torch.cuda.synchronize()
            for name, (got, want) in results.items():
                a_, e = err(got, want)
                emit("ops", fn=name, M=M_, K=K, N=N, max_abs_err=a_, err=e, tol=OPS_TOL)
                if not e <= OPS_TOL:
                    raise AssertionError(f"{name} M={M_} N={N}: error {e} > {OPS_TOL}")
            del a, b, a3, b3, results
    # The tune phase's pipeline probe: bf16, as the calibration runs it,
    # against the plain pipeline on the same inputs (one rounding of each
    # combined operand and of the output in both), and f32 against
    # torch.matmul.
    for M_, K_, N in PROBES:
        for dtype in (torch.bfloat16, torch.float32):
            a, b = randn(M_, K_, dtype=dtype, gen=gen), randn(K_, N, dtype=dtype, gen=gen)
            got = ops.falcon_matmul(a, b, l)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                want, tol, vs = ref.lcma_matmul_ref(a, b, l), TOL[dtype]["fused"], "plain"
            else:
                want, tol, vs = a @ b, OPS_TOL, "torch.matmul"
            a_, e = err(got, want)
            emit("ops", fn="falcon_matmul (tune probe)", M=M_, K=K_, N=N, dtype=str(dtype),
                 against=vs, max_abs_err=a_, err=e, tol=tol)
            if got.shape != want.shape or not e <= tol:
                raise AssertionError(f"falcon_matmul probe {(M_, K_, N)} {dtype}: "
                                     f"{tuple(got.shape)} vs {tuple(want.shape)}, "
                                     f"error {e} > {tol}")
            del a, b, got, want
    # Offline Combine B + int8 of each planned weight in bf16: the
    # group_combine kernel, then the plain absmax and rounding, against the
    # plain version of the whole step.
    for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
        w = randn(K, N, dtype=torch.bfloat16, gen=gen)
        by = scale_block(K // l.k)
        dq, flips, ds = check_quant_combine(
            f"quantize_b_blockwise {K}x{N}", kernels.quantize_b_blockwise(w, l.V, by),
            ref.quantize_b_blockwise_ref(w, l.V, by))
        emit("ops", fn="quantize_b_blockwise", K=K, N=N, by=by, max_dq=dq, flips=flips,
             scale_err=ds, tol=[QUANT_TOL["dq"], QUANT_TOL["scale"]])
    # The int8 pipeline through the engine: forced strassen with the int8
    # tier, a weight planned with its B̃q, dense() -> falcon_matmul_quant.
    with falcon.use(falcon.FalconConfig(mode="strassen", quantize=True)):
        for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            b = randn(K, N, gen=gen)
            pw = falcon.plan_weight(b, m_hint=256)
            for M_ in (256, 4):
                a = randn(M_, K, gen=gen)
                before = kernels.fused_gemm_combine_h_quant.launches
                got = falcon.dense(a, pw)
                if kernels.fused_gemm_combine_h_quant.launches != before + 1:
                    raise AssertionError("ops: dense() on a quantized weight did not "
                                         "launch the int8 kernel")
                want = a @ b
                rel = ((got - want).norm() / want.norm()).item()
                emit("ops", fn="falcon_matmul_quant (dense)", M=M_, K=K, N=N,
                     rel_frobenius_err=rel, tol=OPS_QUANT_TOL)
                if not rel <= OPS_QUANT_TOL:
                    raise AssertionError(f"falcon_matmul_quant M={M_} K={K} N={N}: "
                                         f"relative error {rel} > {OPS_QUANT_TOL}")
            del b, pw
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Times at the main path's shapes
# ---------------------------------------------------------------------------

WARMUP, LAUNCHES, RUNS = 3, 50, 5


def events_ms(fn) -> tuple[float, float]:
    """(device ms, host ms) per call: after WARMUP calls, RUNS runs of
    LAUNCHES back-to-back calls, each between one CUDA event pair (device)
    and one host-clock pair around the enqueueing loop (host); medians."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(RUNS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            fn()
        t1 = time.perf_counter()
        e.record()
        e.synchronize()
        dev.append(s.elapsed_time(e) / LAUNCHES)
        host.append((t1 - t0) * 1e3 / LAUNCHES)
    return statistics.median(dev), statistics.median(host)


def profiler_ms(fn) -> float | None:
    """Device ms per call from torch.profiler: the device time of every
    kernel LAUNCHES calls ran, over LAUNCHES (None if it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / LAUNCHES if us > 0 else None


def time_ms(fn) -> dict:
    """Time per call of ``fn`` (its operands built beforehand). ``ms`` is the
    events' time over back-to-back launches, unless the host's time per call
    exceeds the device's: then the queue ran dry between launches, the events
    measured the host, and ``ms`` is the profiler's device time. ``source``
    says which."""
    ev, host = events_ms(fn)
    dev = profiler_ms(fn)
    host_bound = dev is not None and host > dev
    return {"ms": dev if host_bound else ev, "source": "profiler" if host_bound else "events",
            "events_ms": ev, "host_ms": host, "profiler_ms": dev}


def fused_plan(plan) -> dict:
    """The tile, ring depth and split of a tensor-core fused plan."""
    return {k: plan.as_dict()[k] for k in ("bx", "bz", "bk", "stages", "splits", "blocks")}


def combine_library(x: torch.Tensor, coeff: np.ndarray):
    """One PyTorch call computing Group Combine of ``x`` (2-D, or 3-D with
    the group first) under ``coeff``: an einsum of the coefficients (built on
    the card here, outside the call) with a view of ``x``, f32 sums rounded
    once to ``x``'s dtype as the kernel does."""
    R, d1, d2 = coeff.shape
    c = torch.as_tensor(np.array(coeff, np.float32), dtype=x.dtype, device=x.device)
    *g, rows, cols = x.shape
    xv = x.view(*g, d1, rows // d1, d2, cols // d2)
    eq = "ril,gixly->grxy" if g else "ril,ixly->rxy"
    return lambda: torch.einsum(eq, c, xv)


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / H100_SXM.beta
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_times() -> dict:
    """Each kernel at the largest call the served model makes of it (bf16,
    forced strassen): the tied LM head's runtime Combine B (and Combine A
    at prefill and at decode, of mlp_up and of mlp_down), the Combine A of
    the attention scores at prefill, the mlp_up product at prefill (and at
    decode, and the LM head's at decode: the split reduction) and the
    attention scores product at prefill; the int8 kernels at mlp_up; the
    tiled GEMM at the tune path's three probes and at decode rows."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    l = alg.get("strassen")
    bf = torch.bfloat16
    it = 2
    fx = H100_SXM.flops_for("bfloat16")
    fa = H100_SXM.flops_for("float32")         # combines run on the CUDA cores
    out = {}

    def record(name, kfn, pfn, flops, nbytes, peak, logical, library="matmul", plan=None):
        """Time kernel ``name`` (``name@<tag>`` for a second call shape)
        after checking it once more against its plain version. The library
        yardstick is bf16 ``torch.matmul`` of the logical shape for a
        product kernel, or the ``library`` call where one is given (None:
        none; a Group Combine's computes the same function and is held to
        the plain version too). Kernel, plain version and yardsticks are
        timed alike.
        ``plan``: the kernel's plan for this call as a dict (the tile, ring
        stages and splits of a product kernel; the Group Combine's vector
        width, block and rows), printed on the line."""
        kernel = name.split("@")[0]
        got = kfn()
        torch.cuda.synchronize()
        if kernel == "group_combine_quant":
            a, _, e = check_quant_combine(f"time/{name}", got, pfn())
            tol = QUANT_TOL["scale"]
        else:
            a, e = err(got, pfn())
            tol = (QUANT_TOL[bf] if kernel.endswith("_quant")
                   else TOL[bf]["combine" if kernel.endswith("group_combine") else "fused"])
            if not e <= tol:
                raise AssertionError(f"time/{name}: error {e} > {tol}")
        del got
        lib_err = None
        if callable(library) and kernel.endswith("group_combine"):
            _, lib_err = err(library(), pfn())      # the same function, checked
            if not lib_err <= tol:
                raise AssertionError(f"time/{name}: library error {lib_err} > {tol}")
        k, plain = time_ms(kfn), time_ms(pfn)
        Mq, Kq, Nq, G = logical
        xa = randn(G, Mq, Kq, dtype=bf, gen=gen) if G > 1 else randn(Mq, Kq, dtype=bf, gen=gen)
        xb = randn(G, Kq, Nq, dtype=bf, gen=gen) if G > 1 else randn(Kq, Nq, dtype=bf, gen=gen)
        matmul = time_ms(lambda: torch.matmul(xa, xb))
        if callable(library):
            lib = time_ms(library)
        else:
            lib = matmul if library == "matmul" else None
        bms, by = bound_ms(flops, nbytes, peak)
        out[name] = {"ms": k["ms"], "source": k["source"], "plain_ms": plain["ms"],
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": lib and lib["ms"], "library_err": lib_err,
                     "matmul_ms": matmul["ms"],
                     "max_abs_err": a, "err": e, "tol": tol,
                     "logical_mkn": [Mq, Kq, Nq], "groups": G,
                     "plan": plan,
                     "timing": {"kernel": k, "plain": plain, "matmul": matmul,
                                "library": lib}}
        emit("time", kernel=name, **out[name])

    # LM head Combine B: embed.T (2048, 49408) -> (7, 1024, 24704); Combine
    # A at prefill (256 rows) and at decode (4) of a K = 2048 leaf (mlp_up,
    # the attention projections) and of mlp_down (K = 8192)
    for tag, (rows, cols), coeff, nnz, mkn in (
            ("", (2048, 49408), l.V, l.nnz_v, (256, 2048, 49408)),
            ("@prefill_a", (256, 2048), l.U, l.nnz_u, (256, 2048, 8192)),
            ("@decode_a", (4, 2048), l.U, l.nnz_u, (4, 2048, 8192)),
            ("@prefill_a_down", (256, 8192), l.U, l.nnz_u, (256, 8192, 2048)),
            ("@decode_a_down", (4, 8192), l.U, l.nnz_u, (4, 8192, 2048))):
        x = randn(rows, cols, dtype=bf, gen=gen)
        X, Y = rows // 2, cols // 2
        record("group_combine" + tag, lambda: kernels.group_combine(x, coeff),
               lambda: ref.group_combine_ref(ref.split_blocks(x, 2, 2), coeff),
               2.0 * nnz * X * Y, (4 + l.R) * X * Y * it, fa, (*mkn, 1),
               library=combine_library(x, coeff), plan=launch_plan(x, coeff).as_dict())
        del x
    # attention scores Combine A at prefill: q (B*H=128, 64, 64)
    x3 = randn(128, 64, 64, dtype=bf, gen=gen)
    X, Y = 32, 32
    record("batched_group_combine", lambda: kernels.batched_group_combine(x3, l.U),
           lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.U),
           128 * 2.0 * l.nnz_u * X * Y, 128 * (4 + l.R) * X * Y * it, fa, (64, 64, 80, 128),
           library=combine_library(x3, l.U), plan=launch_plan(x3, l.U).as_dict())
    # mlp_up at prefill: (256, 2048) @ (2048, 8192); at decode, M = 4; the
    # tied LM head at decode: (4, 2048) @ (2048, 49408)
    for tag, (Mq, X, Y, Z) in (("", (256, 128, 1024, 4096)), ("@decode", (4, 2, 1024, 4096)),
                               ("@lm_head_decode", (4, 2, 1024, 24704))):
        at = randn(l.R, X, Y, dtype=bf, gen=gen)
        bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
        record("fused_gemm_combine_h" + tag, lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
               lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
               2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
               (Mq, 2 * Y, 2 * Z, 1),
               plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2)))
        del at, bt
    # attention scores at prefill: 128 groups of (64, 64) @ (64, 80)
    G, X, Y, Z = 128, 32, 32, 40
    at4 = randn(G, l.R, X, Y, dtype=bf, gen=gen)
    bt4 = randn(G, l.R, Y, Z, dtype=bf, gen=gen)
    record("batched_fused_gemm_combine_h",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (64, 64, 80, G), plan=fused_plan(tuning.plan_fused_tc(G, X, Y, Z, l.R, 2, 2)))
    del at4, bt4
    # The int8 path (auto mode with --quant): mlp_up (2048 -> 8192) at
    # prefill, M = 256, and at decode, M = 4. Y = 1024, by = 128.
    fq = H100_SXM.flops_for("int8")
    Y, Z = 1024, 4096
    by = scale_block(Y)
    w = randn(2048, 8192, dtype=bf, gen=gen)
    bq, bs = kernels.quantize_b_blockwise(w, l.V, by)
    del w
    for M_, tag in ((256, ""), (4, "@decode")):
        X = M_ // 2
        a = randn(M_, 2048, dtype=bf, gen=gen)
        record("group_combine_quant" + tag,
               lambda: kernels.group_combine_quant(a, l.U, by),
               lambda: ref.group_combine_quant_ref(a, l.U, by),
               2.0 * l.nnz_u * X * Y + 2.0 * l.R * X * Y,
               M_ * 2048 * it + l.R * X * Y + 4 * l.R * X * (Y // by), fa,
               (M_, 2048, 8192, 1), library=None)
        aq, as_ = kernels.group_combine_quant(a, l.U, by)
        a8 = torch.randint(-127, 128, (M_, 2048), device=DEV, generator=gen, dtype=torch.int8)
        b8 = torch.randint(-127, 128, (8192, 2048), device=DEV, generator=gen,
                           dtype=torch.int8).t()
        record("fused_gemm_combine_h_quant" + tag,
               lambda: kernels.fused_gemm_combine_h_quant(aq, as_, bq, bs, l.W, out_dtype=bf),
               lambda: ref.fused_gemm_combine_h_quant_ref(aq, as_, bq, bs, l.W, bf),
               2.0 * l.R * X * Y * Z,
               l.R * (X * Y + Y * Z) + 4 * l.R * (X + Z) * (Y // by) + 4 * X * Z * it, fq,
               (M_, 2048, 8192, 1),
               # torch._int_mm, the int8 product of the logical shape: M > 16 only
               library=(lambda: torch._int_mm(a8, b8)) if M_ > 16 else None,
               plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2, by=by)))
    del aq, as_, bq, bs, a8, b8
    # The tiled GEMM on the tune path, bf16 on the tensor-core route: its
    # two short-M probes (bound by bytes) and the 4096^3 probe (bound by
    # operations); and decode rows (K split across blocks).
    for (M_, K, N), tag in (((256, 2048, 8192), ""), ((256, 8192, 2048), "@probe2"),
                            ((4096, 4096, 4096), "@4096"), ((4, 2048, 8192), "@decode")):
        a, b = randn(M_, K, dtype=bf, gen=gen), randn(K, N, dtype=bf, gen=gen)
        tiled_call(a, b, "wgmma")
        record("tiled_matmul" + tag, lambda: kernels.tiled_matmul(a, b),
               lambda: ref.tiled_matmul_ref(a, b), 2.0 * M_ * K * N,
               (M_ * K + K * N + M_ * N) * it, fx, (M_, K, N, 1),
               plan={"route": "wgmma", **tuning.plan_tiled_wgmma(M_, K, N).as_dict()})
        del a, b
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Model parity, serving, decisions
# ---------------------------------------------------------------------------

def phase_parity() -> None:
    base = dataclasses.replace(get_config("granite_3_2b"), num_layers=2, dtype="float32")
    params = M.init_params(base, 0, DEV)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, base.vocab_size, (4, 64)),
                             device=DEV)
    logits = {}
    with torch.inference_mode():
        for mode in ("strassen", "gemm"):
            cfg = dataclasses.replace(base, falcon_mode=mode)
            with falcon.use(M.falcon_config_for(cfg)):
                p, n_pre = falcon.precombine_params(params, m_hint=4 * 64)
                logits[mode], _ = M.forward(p, cfg, tokens, logits_mode="last")
    V = base.vocab_size                 # the padded columns hold -1e30 in both
    a, e = err(logits["strassen"][..., :V], logits["gemm"][..., :V])
    same = (logits["strassen"].argmax(-1) == logits["gemm"].argmax(-1)).float().mean().item()
    emit("parity", layers=2, dtype="float32", max_abs_err=a, err=e, tol=PARITY_TOL,
         argmax_agreement=same)
    if not e <= PARITY_TOL:
        raise AssertionError(f"parity: strassen vs gemm logits error {e} > {PARITY_TOL}")
    del params, logits
    torch.cuda.empty_cache()


BATCH, PROMPT, GEN = 4, 64, 16


def serve(phase: str, cfg, params, quantize: bool = False) -> tuple[dict, dict]:
    """One full-width one-shot serve through ``run_oneshot``, the launch
    counts set to 0 just before it and read just after. Emits the phase's
    line, checks the tokens and logits, returns (result, launch counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_oneshot(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0, device=DEV,
                      params=params, quantize=quantize)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    logits = torch.stack(res["logits"])
    finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all().item())
    tok = res["tokens"]
    emit(phase, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         mode=cfg.falcon_mode, quantize=quantize, batch=BATCH, prompt_len=PROMPT,
         new_tokens=GEN, n_precombined=res["n_precombined"], quantized=res["quantized"],
         **res["timings"], max_memory_allocated=peak, launches=counts,
         launches_by_phase=res["launches"],
         group_combine_by_shape={"x".join(map(str, k)): v
                                 for k, v in kernels.group_combine.shapes.items()},
         logits_finite=finite, sample=tok[0].tolist())
    if not finite or logits.shape[-1] != M.padded_vocab(cfg):
        raise AssertionError(f"{phase}: logits not finite or of the wrong width")
    if tok.shape != (BATCH, GEN) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase}: tokens out of range: {tok}")
    return res, counts


def check_int8_launches(phase: str, res: dict, n_leaves: int, layers: int) -> None:
    """Both int8 kernels ran once per quantized leaf and layer at prefill and
    at every decode step."""
    per_step = n_leaves * layers
    want = {"prefill": per_step, "decode": per_step * (GEN - 1)}
    for name in ("group_combine_quant", "fused_gemm_combine_h_quant"):
        got = {p: res["launches"][p][name] for p in want}
        if got != want:
            raise AssertionError(f"{phase}: {name} launched {got}, expected {want}")


def quality(phase: str, q: dict, fp: dict, vocab: int) -> float:
    """A serve against fp serving on the same weights: the largest logit
    error over the steps each request's tokens still agree (prefix-matched,
    as tests/test_quant_serve.py), relative to that request's largest fp
    logit. Returns it."""
    worst, compared = 0.0, 0
    for b in range(BATCH):
        scale = max(lg[b, :vocab].float().abs().max().item() for lg in fp["logits"])
        for t in range(GEN):
            if not torch.equal(q["tokens"][b, :t], fp["tokens"][b, :t]):
                break
            d = (q["logits"][t][b, :vocab].float() - fp["logits"][t][b, :vocab].float())
            worst = max(worst, d.abs().max().item() / max(scale, 1e-30))
            compared += 1
    same = (q["tokens"] == fp["tokens"]).float().mean().item()
    emit("quality", of=phase, steps_compared=compared, rel_logit_err=worst,
         tol=QUALITY_TOL, token_agreement=same)
    if compared < BATCH or not worst <= QUALITY_TOL:
        raise AssertionError(f"{phase}: logit error against fp {worst} over {compared} "
                             f"steps (tolerance {QUALITY_TOL})")
    return worst


def phase_serve() -> tuple[dict, dict]:
    """Slice 1's path: bf16, forced strassen, every fp kernel. Returns the
    launch counts and the run (the int8 forced run is held to it)."""
    cfg = dataclasses.replace(get_config("granite_3_2b"), falcon_mode="strassen")
    params = M.init_params(cfg, 0, DEV)
    res, counts = serve("serve", cfg, params)
    if res["n_precombined"] != 7:
        raise AssertionError(f"serve: {res['n_precombined']} stacked leaves precombined, "
                             f"expected 7")
    fp_kernels = ("group_combine", "batched_group_combine", "fused_gemm_combine_h",
                  "batched_fused_gemm_combine_h")
    if min(counts[k] for k in fp_kernels) <= 0:
        raise AssertionError(f"serve: a kernel was never launched: {counts}")
    profile_serve("profile", cfg, params)
    del params
    torch.cuda.empty_cache()
    return counts, {k: res[k] for k in ("logits", "tokens")}


def phase_serve_quant() -> tuple[dict, dict]:
    """The int8 path as a user starts it (``--quant``): auto mode on the
    h100_sxm profile. The leaves it quantizes must be those the Decision
    Module prices to int8 at the prefill M; both int8 kernels run at prefill
    and every decode step. Held to the fp run (auto: every product on GEMM)
    on the same weights. Returns the launch counts and the fp auto run."""
    cfg = get_config("granite_3_2b")
    params = M.init_params(cfg, 0, DEV)
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=True)
    priced = sorted(f"layers/{grp}/{name}" for grp in ("attn", "mlp")
                    for name, w in params["layers"][grp].items()
                    if falcon.plan(BATCH * PROMPT, *w.shape[-2:], fcfg, cfg.dtype,
                                   precombined_b=True).quantized)
    fp, _ = serve("serve_fp_auto", cfg, params)
    res, counts = serve("serve_quant", cfg, params, quantize=True)
    if sorted(res["quantized"]) != priced or priced != ["layers/mlp/mlp_gate",
                                                        "layers/mlp/mlp_up"]:
        raise AssertionError(f"serve_quant: quantized {res['quantized']}, the pricing "
                             f"names {priced}")
    check_int8_launches("serve_quant", res, len(priced), cfg.num_layers)
    quality("serve_quant", res, fp, cfg.vocab_size)
    del res
    profile_serve("profile_quant", cfg, params, quantize=True)
    del params
    torch.cuda.empty_cache()
    return counts, {k: fp[k] for k in ("logits", "tokens")}


def phase_serve_quant_forced(fp_forced: dict) -> None:
    """Forced strassen with the int8 tier: all seven leaves int8, held to
    the forced fp run of ``phase_serve`` on the same weights (seed 0)."""
    cfg = dataclasses.replace(get_config("granite_3_2b"), falcon_mode="strassen")
    params = M.init_params(cfg, 0, DEV)
    res, _ = serve("serve_quant_forced", cfg, params, quantize=True)
    if res["n_quantized"] != 7:
        raise AssertionError(f"serve_quant_forced: {res['quantized']} quantized, "
                             f"expected all 7 leaves")
    check_int8_launches("serve_quant_forced", res, 7, cfg.num_layers)
    quality("serve_quant_forced", res, fp_forced, cfg.vocab_size)
    del res
    profile_serve("profile_quant_forced", cfg, params, quantize=True)
    del params
    torch.cuda.empty_cache()


def profile_serve(phase: str, cfg, params, quantize: bool = False) -> None:
    """Where the time of serving goes: prefill and one decode step, against
    weights precombined beforehand (outside the window), under
    torch.profiler: device time by kernel and the share of the window the
    device was busy. Then the same run under cProfile (:func:`host_split`)."""
    from torch.profiler import ProfilerActivity, profile
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=quantize)
    with falcon.use(fcfg), torch.inference_mode():
        planned, _ = falcon.precombine_params(params, m_hint=BATCH * PROMPT)
    run = functools.partial(run_oneshot, cfg, batch=BATCH, prompt_len=PROMPT, gen=2,
                            seed=0, device=DEV, params=planned, precombine=False,
                            quantize=quantize)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = lambda e: getattr(e, "self_device_time_total", 0)  # noqa: E731
    dev.sort(key=us, reverse=True)
    device_ms = sum(us(e) for e in dev) / 1e3
    emit(phase, window="prefill + 1 decode step (profiler on)",
         wall_ms=wall_ms, timings=res["timings"],
         device_ms=device_ms if dev else "not measured",
         busy_share=device_ms / wall_ms if dev else "not measured",
         top=[{"kernel": e.key[:90], "ms": us(e) / 1e3, "calls": e.count}
              for e in dev[:12]],
         host=host_split(run))


def host_split(run) -> dict:
    """``run()`` under cProfile: the host ms inside the model's forward,
    inside the ops pipelines (``kernels/ops.py``) and inside the kernel
    wrappers (the functions that count launches), each summed over its
    calls. cProfile slows the host, so the shares are what to read."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    key = lambda f: (f.__code__.co_filename, f.__code__.co_firstlineno,  # noqa: E731
                     f.__code__.co_name)
    cum = lambda fns: sum(stats[key(f)][3] for f in fns if key(f) in stats) * 1e3  # noqa: E731
    pipelines = (ops.falcon_matmul, ops.falcon_matmul_precombined, ops.falcon_grouped_matmul,
                 ops.falcon_grouped_matmul_precombined, ops.falcon_matmul_quant, ops.matmul)
    return {"wall_ms": wall_ms, "forward_ms": cum([M.forward]), "ops_ms": cum(pipelines),
            "wrappers_ms": cum(kernels.KERNELS)}


def phase_decisions() -> None:
    shapes = {"w_q/w_o": (2048, 2048), "w_k/w_v": (2048, 512), "mlp_gate/up": (2048, 8192),
              "mlp_down": (8192, 2048), "lm_head": (2048, 49408)}
    cfg = falcon.FalconConfig()                      # auto mode on h100_sxm
    for quantize in (False, True):
        c = dataclasses.replace(cfg, quantize=quantize)
        out = {}
        for M_ in (4, 256, 4096):
            for name, (K, N) in shapes.items():
                for pre in (False, True):
                    d = falcon.plan(M_, K, N, c, "bfloat16", precombined_b=pre)
                    key = f"M={M_} {name}{' precombined' if pre else ''}"
                    out[key] = (f"{d.algo.name}/{d.precision} ({d.speedup:.3f}x)"
                                if d.use_lcma else "gemm")
        emit("decisions", hardware=cfg.hardware, quantize=quantize, decisions=out)


# ---------------------------------------------------------------------------
# The calibration path: tune CLI -> calibrated profile + warmed plan cache ->
# serving under it
# ---------------------------------------------------------------------------

TUNED = "h100_sxm_autotuned"
TUNE_OUT = os.path.join(ROOT, "build", "tune", f"{TUNED}.json")
TUNE_ARGV = ["--hardware", "h100_sxm", "--backend", "cuda", "--dtype", "bfloat16",
             "--quant", "--warm-workload", "granite_3_2b",
             *(a for mkn in PROBES for a in ("--shape", ",".join(map(str, mkn)))),
             "--out", TUNE_OUT]
# granite_3_2b's planned leaves as (K, N): d 2048, 32 x 64 query and 8 x 64
# key/value heads, d_ff 8192
LEAVES = {"w_q": (2048, 2048), "w_k": (2048, 512), "w_v": (2048, 512),
          "w_o": (2048, 2048), "mlp_gate": (2048, 8192), "mlp_up": (2048, 8192),
          "mlp_down": (8192, 2048)}


def phase_tune() -> tuple[dict, str]:
    """``python -m repro_torch.tools.tune`` in this process (so the serve
    below resolves the very profile it registers): the probes time the tiled
    GEMM, Group Combine A, the fused kernel, the LCMA pipeline, torch._int_mm
    and the quant Group Combine on the card; the CLI prints its static vs
    calibrated table, writes the profile and warms the plan cache. Returns
    the launch counts of the run and the plan cache's path."""
    from repro_torch.core.hardware import get_profile
    from repro_torch.tools import tune
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = tune.main(TUNE_ARGV)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    routes = dict(kernels.tiled_matmul.routes)
    if rc != 0 or counts["tiled_matmul"] <= 0:
        raise AssertionError(f"tune: exit {rc}, launches {counts}")
    if routes != {"wgmma": counts["tiled_matmul"], "simt": 0}:
        raise AssertionError(f"tune: the bf16 probes' tiled GEMM calls took routes {routes}, "
                             f"expected all {counts['tiled_matmul']} on wgmma")
    with open(TUNE_OUT) as f:
        meta = json.load(f)["_metadata"]
    prof = get_profile(TUNED)
    cal = {"flops_mul": prof.flops_mul, "flops_add": prof.flops_add, "beta": prof.beta,
           "lcma_gemm_efficiency": prof.lcma_gemm_efficiency,
           "flops_int8": meta["flops_int8"], "beta_quant": meta["beta_quant"]}
    static = {"flops_mul": H100_SXM.flops_for("bfloat16"), "flops_add": H100_SXM.flops_add,
              "beta": H100_SXM.beta, "lcma_gemm_efficiency": H100_SXM.lcma_gemm_efficiency,
              "flops_int8": H100_SXM.flops_for("int8"), "beta_quant": None}
    if not all(np.isfinite(v) and v > 0 for v in cal.values()):
        raise AssertionError(f"tune: calibrated numbers not finite and positive: {cal}")
    plans = os.path.join(os.path.dirname(TUNE_OUT), f"{TUNED}.plans.json")
    emit("tune", argv=TUNE_ARGV, seconds=seconds, profile=TUNE_OUT, plans=plans,
         static=static, calibrated=cal, model_rel_err=meta["model_rel_err"],
         probes=meta["probes"], launches=counts,
         tiled_matmul_launches=counts["tiled_matmul"], tiled_matmul_routes=routes)
    return counts, plans


def phase_decisions_tuned() -> None:
    """Each granite leaf (precombined, as a PlannedWeight is priced) at the
    prefill and decode M, fp and int8 tiers, on the data sheet and on the
    calibrated profile side by side: the scheme, precision and predicted
    speedup taken, or for GEMM the best candidate's predicted speedup."""
    out = {}
    for quantize in (False, True):
        for M_ in (256, 4):
            for leaf, (K, N) in LEAVES.items():
                row = {}
                for hw in ("h100_sxm", TUNED):
                    c = falcon.FalconConfig(hardware=hw, quantize=quantize,
                                            use_plan_cache=False)
                    d = falcon.plan(M_, K, N, c, "bfloat16", precombined_b=True)
                    best = min(d.estimates, key=lambda e: e.time, default=None)
                    row[hw] = (f"{d.algo.name}/{d.precision} ({d.speedup:.3f}x)" if d.use_lcma
                               else f"gemm (best {best.lcma.name}/{best.precision} "
                                    f"{d.gemm_seconds / best.time:.3f}x)" if best
                               else "gemm (Eq. 8: memory-bound)")
                out[f"{'int8 tier' if quantize else 'fp'} M={M_} {leaf}"] = row
    emit("decisions_tuned", decisions=out)


def phase_serve_tuned(fp_auto: dict, plans: str) -> dict:
    """Full granite, bf16, auto mode under the calibrated profile, the plan
    cache loaded from the tune phase's file as ``--plan-cache`` loads it and
    flushed after. Held to the fp auto run on the same weights: within
    QUALITY_TOL, and exactly equal where no kernel ran (every product on
    the same torch.matmul). Returns the launch counts."""
    cfg = get_config("granite_3_2b")
    params = M.init_params(cfg, 0, DEV)
    cache = plan_cache.configure(path=plans)
    loaded = len(cache)
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), hardware=TUNED)
    with falcon.use(fcfg):
        res, counts = serve("serve_tuned", cfg, params)
    st = plan_cache.stats().as_dict()
    plan_cache.flush()
    planned = sorted(f"layers/{grp}/{name}" for grp in ("attn", "mlp")
                     for name, w in params["layers"][grp].items()
                     if falcon.plan(BATCH * PROMPT, *w.shape[-2:], fcfg, cfg.dtype,
                                    precombined_b=True).use_lcma)
    emit("serve_tuned_plan", hardware=TUNED, planned=planned,
         n_precombined=res["n_precombined"], plans_loaded=loaded, plan_cache=st)
    if res["n_precombined"] != len(planned):
        raise AssertionError(f"serve_tuned: {res['n_precombined']} leaves precombined, "
                             f"the pricing names {planned}")
    worst = quality("serve_tuned", res, fp_auto, cfg.vocab_size)
    if sum(counts.values()) == 0 and worst != 0.0:
        raise AssertionError(f"serve_tuned: no kernel ran, yet the logits differ from "
                             f"the fp auto run by {worst}")
    del params, res
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    emit("build", seconds=build.build_all(), wall=time.perf_counter() - t0)
    emit("ptxas", kernels={name: build.ptxas_report(name)
                           for name in ("tiled_matmul", "group_combine")})
    phase_kernels()
    phase_quant_kernels()
    phase_tiled_kernels()
    phase_ops()
    times = phase_times()
    phase_parity()
    counts, fp_forced = phase_serve()
    # each path's kernels count launches from its own run
    quant_counts, fp_auto = phase_serve_quant()
    counts.update({k: v for k, v in quant_counts.items() if k.endswith("_quant")})
    phase_serve_quant_forced(fp_forced)
    phase_decisions()
    tune_counts, plans = phase_tune()
    counts["tiled_matmul"] = tune_counts["tiled_matmul"]
    phase_decisions_tuned()
    phase_serve_tuned(fp_auto, plans)
    emit("total", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": counts[k], "max_abs_err": times[k]["max_abs_err"],
         "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
         "bound_ms": times[k]["bound_ms"], "bound_by": times[k]["bound_by"],
         "library_ms": times[k]["library_ms"]} for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
