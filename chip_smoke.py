"""Drive the PyTorch/CUDA port of FalconGEMM on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each: device, build (nvcc for sm_90a from
src/repro_torch/csrc, one process per source, all at once; then ptxas's
registers, shared memory and spills of the tiled GEMM's, the Group
Combine's and the quantizing Combine A's kernels), every kernel entry
point against its plain PyTorch version (six schemes x f32/bf16 x ragged
shapes, ragged decode rows whose reduction the tensor-core fused kernels split
across blocks, and every shape the served model gives the kernel, the
continuous engine's bucket steps among them (bf16); the int8
kernels likewise, the quantizing Combine A bit-equal on both its routes,
each case's route asserted; the tiled GEMM at ragged, unaligned, probe and decode
shapes, each case's route asserted: the tensor cores for aligned bf16, the
SIMT kernel for f32, ragged and misaligned operands), the ops pipelines
against torch.matmul at granite shapes, kernel times (CUDA events around 50
back-to-back launches, or the profiler's device time where the wrapper's host
cost exceeds the kernel's; each line carries the call's plan: tile, ring
stages and splits, or the Group Combine's vector width and block, or the
quantizing Combine A's route, lanes and rank split), model parity (2 layers at
full width, f32, strassen vs gemm), serving full granite_3_2b (40 layers, bf16,
4 requests x 16 tokens) three ways with every kernel's launch count: forced
strassen, int8 in auto mode (``--quant``) and int8 with forced strassen, each
int8 run held to the fp run on the same weights; the continuous-batching
ServeEngine on full granite_3_2b (16 ragged requests over 8 slots: forced
strassen fp, forced strassen int8 and auto mode fp, each with every bucket's
step replayed as a CUDA graph and eagerly, the two held to identical tokens
and equal launch counts, each held to one-shot fp serving of the same
requests, with the decode step profiled both ways and the 8-row step timed
alone and in the engine, with and without the logits' copy to the host;
then speculation with the prefix cache and chunked prefill); what auto mode
decides on the
h100_sxm profile; then the calibration path: ``repro_torch.tools.tune``
measures the card (through the tiled GEMM), the data-sheet and calibrated
decisions side by side, and granite served in auto mode under the calibrated
profile with the warmed plan cache, held to the fp auto run. Then the
reference's other dense archs at full width (mistral_nemo_12b,
starcoder2_15b, gemma3_27b): each leaf auto mode plans at a 2048-row
prefill timed alone on torch.matmul and the "cuda" and generated "torch"
planned paths, each held to the plain version, beside its predicted
speedup; each arch served one-shot at that prefill, auto against gemm
(starcoder2 also on "torch"), depth cut where weights and B̃ exceed the
card, held to gemm prefix-matched and teacher-forced; each arch's
ServeEngine at published depth, graphs against eager. Offline Combine B
of those leaves (one launch over all served layers) is held to its plain
version layer by layer among the kernel cases.
Any failure raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is missing. Needs a CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
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
from repro_torch.core import algorithms as alg, codegen, plan_cache, workloads  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.lcma import LCMA  # noqa: E402
from repro_torch.kernels import build, ops, ref, tuning  # noqa: E402
from repro_torch.kernels.group_combine import launch_plan  # noqa: E402
from repro_torch.kernels.quant_combine import launch_plan as quant_plan  # noqa: E402
from repro_torch.kernels.quant_combine import scale_block  # noqa: E402
from repro_torch.launch.serve import run_oneshot  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.buckets import BucketPolicy, next_pow2  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

DEV = "cuda"
# Kernel vs plain version, error normalized by max(1, max|plain|). f32: the
# same f32 arithmetic in another summation order. bf16: both round one f32
# value once, so they differ by at most one bf16 ulp (2**-7 relative).
TOL = {torch.float32: {"combine": 1e-5, "fused": 1e-4},
       torch.bfloat16: {"combine": 1e-2, "fused": 1e-2}}
# int8 kernels vs plain versions. Quant Group Combine A: the same f32
# operations in the same order, so q and the scales are bit-equal (QUANT_EXACT:
# no q differs, no scale differs). Offline Combine B + int8
# (quantize_b_blockwise, the Group Combine kernel then plain rounding): q
# within one step, the scales within 1e-6 relative. Fused int8: exact int
# sums, the same dequantize and Combine H order; f32 out 1e-5 normalized,
# bf16 out one bf16 ulp.
QUANT_TOL = {"dq": 1, "scale": 1e-6, torch.float32: 1e-5, torch.bfloat16: 1e-2}
QUANT_EXACT = {"dq": 0, "scale": 0.0}
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

def combine_case(l, dtype, shape, which, gen, groups=None):
    coeff = l.U if which == "U" else l.V
    d1, d2 = coeff.shape[1:]
    rows, cols = shape
    x = randn(*(((groups,) if groups else ()) + (d1 * cdiv(rows, d1), d2 * cdiv(cols, d2))),
              dtype=dtype, gen=gen)
    k = kernels.batched_group_combine if groups else kernels.group_combine
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

# The continuous engine of phase serve_engine: 8 slots, prompts of up to 64
# tokens, 16 new ones; its speculative run takes γ = 2 and 16-token chunks.
ENGINE = dict(max_slots=8, max_prompt_len=64, max_new_tokens=16)
ENGINE_SPEC = dict(speculate=2, prefix_cache=True, prefill_chunk=16)


def engine_policy(spec: bool) -> BucketPolicy:
    """The bucket grid ServeEngine builds for ENGINE (and ENGINE_SPEC):
    with chunks, prefill buckets top out at the chunk."""
    seq = min(ENGINE["max_prompt_len"], ENGINE_SPEC["prefill_chunk"] if spec else 1 << 30)
    return BucketPolicy.build(seq, ENGINE["max_slots"])


def engine_keys(spec: bool) -> int:
    """The slot cache's length, as ServeEngine sizes it."""
    gamma = ENGINE_SPEC["speculate"] if spec else 0
    return next_pow2(max(engine_policy(spec).prefill_seq[-1], ENGINE["max_prompt_len"])
                     + ENGINE["max_new_tokens"] + gamma)


def engine_steps(spec: bool) -> list[tuple[int, int]]:
    """(rows, tokens per row) of every step the engine runs: each prefill
    bucket and decode bucket; speculating, also each verify step's γ+1
    tokens and the draft's 2-token catch-up (the draft's own prefill and
    1-token steps are the target's shapes)."""
    pol = engine_policy(spec)
    steps = pol.prefill_shapes() + [(b, 1) for b in pol.decode_batch]
    if spec:
        steps += [(b, n) for b in pol.decode_batch for n in (ENGINE_SPEC["speculate"] + 1, 2)]
    return steps


def engine_products() -> tuple[list, list, list]:
    """The shapes the engine runs give the kernels (in bf16), beyond PROJ
    and ATTN:
    (projections (M, K, N) of the plain and the speculative runs, those of
    the plain run (the int8 run's), attention (groups, M, K, N)). M = rows x
    tokens; the LM head takes each step's logit rows (a subset of these M).
    Attention: rows x heads, each step's tokens as queries against the slot
    cache's keys."""
    cfg = get_config("granite_3_2b")
    heads, hd = cfg.num_heads, cfg.resolved_head_dim
    leaves = sorted({(K, N) for _, K, N in PROJ})
    plain = sorted({b * s for b, s in engine_steps(False)} - {M_ for M_, _, _ in PROJ})
    rows = sorted({b * s for spec in (False, True) for b, s in engine_steps(spec)}
                  - {M_ for M_, _, _ in PROJ})
    attn = sorted({(b * heads, s, k, n) for spec in (False, True) for b, s in engine_steps(spec)
                   for k, n in ((hd, engine_keys(spec)), (engine_keys(spec), hd))})
    return ([(M_, K, N) for M_ in rows for K, N in leaves],
            [(M_, K, N) for M_ in plain for K, N in leaves], attn)


def kernel_cases(l, dtype, gen):
    """Generators of (kernel call, plain call) per entry point: ragged shapes,
    then every shape the main path gives the kernel under scheme ``l`` (the
    served model's products and the tune phase's probes). Lazy, so only one
    case's tensors live at a time."""
    g = lambda M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
    # the engine serves bf16 only; cases are kept once per padded shape
    # (the kernel's view: rows and columns in whole blocks)
    engine_proj, _, engine_attn = engine_products() if dtype == torch.bfloat16 else ([], [], [])
    products = sorted(set(PROJ + PROBES + engine_proj))
    weights = sorted({(K, N) for _, K, N in products})
    return {
        "group_combine": itertools.chain(
            [combine_case(l, dtype, (37 * l.m, 53 * l.k), "U", gen),
             combine_case(l, dtype, (53 * l.k, 29 * l.n), "V", gen)],
            (combine_case(l, dtype, (X * l.m, Y * l.k), "U", gen)
             for X, Y, _ in sorted({g(*mkn) for mkn in products})),
            # Combine B: offline for the projections, each step for the LM
            # head, each call of the pipeline probe
            (combine_case(l, dtype, kn, "V", gen) for kn in weights)),
        "batched_group_combine": itertools.chain(
            [combine_case(l, dtype, (19 * l.m, 23 * l.k), "U", gen, 3)],
            (combine_case(l, dtype, (M_, K), "U", gen, 3) for M_, K, _ in ATTN),
            (combine_case(l, dtype, (K, N), "V", gen, 3) for _, K, N in ATTN[:2]),
            # the engine's: both operands of each product are activations
            (combine_case(l, dtype, (X * l.m, Y * l.k), "U", gen, G)
             for G, X, Y, _ in sorted({(G, *g(*mkn)) for G, *mkn in engine_attn})),
            (combine_case(l, dtype, (K, N), "V", gen, G)
             for G, K, N in sorted({(G, K, N) for G, _, K, N in engine_attn}))),
        "fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 37, 53, 45, gen),
             # ragged decode rows, the reduction split across blocks (bf16)
             fused_case(l, dtype, 3, 301, 45, gen, split=True)],
            (fused_case(l, dtype, *xyz, gen) for xyz in sorted({g(*mkn) for mkn in products}))),
        "batched_fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 19, 23, 21, gen, groups=3),
             fused_case(l, dtype, 19, 23, 21, gen, groups=3, shared=True),
             fused_case(l, dtype, 2, 333, 45, gen, groups=3, shared=True, split=True),
             fused_case(l, dtype, *g(4, 2048, 2048), gen, groups=2, shared=True)],
            (fused_case(l, dtype, *g(*mkn), gen, groups=128) for mkn in ATTN),
            (fused_case(l, dtype, *xyz, gen, groups=G)
             for G, *xyz in sorted({(G, *g(*mkn)) for G, *mkn in engine_attn}))),
    }


def phase_kernels() -> None:
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst, seconds = {}, {}
    n = 0
    for l in schemes():
        for dtype in (torch.float32, torch.bfloat16):
            for name, fns in kernel_cases(l, dtype, gen).items():
                kind = "fused" if "fused" in name else "combine"
                tol = TOL[dtype][kind]
                t0 = time.perf_counter()
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
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    # Offline Combine B of the new archs' served leaves: one launch over the
    # whole stack of layers (bf16, the planned scheme)
    name, tol = "batched_group_combine", TOL[torch.bfloat16]["combine"]
    for scheme, G, K, N in stacked_weight_cases():
        t0 = time.perf_counter()
        a, e, shape = check_stacked_combine(alg.get(scheme), G, K, N, gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(torch.bfloat16),
             shape=shape, max_abs_err=a, err=e, tol=tol, stacked_weight=[G, K, N])
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/stack {(G, K, N)}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    emit("kernels", cases=n, worst_err=worst, seconds=seconds)


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


def check_quant_combine(what: str, got, want, tol=QUANT_TOL) -> tuple[int, int, float]:
    dq, flips, ds = quant_combine_err(got, want)
    if dq > tol["dq"] or not ds <= tol["scale"]:
        raise AssertionError(f"{what}: |dq| {dq} ({flips} flips), scale error {ds}, "
                             f"tolerance {tol}")
    return dq, flips, ds


def routed(kernel, want_route: str, *args, **kw):
    """``kernel(*args, **kw)``, checked by the wrapper's ``routes`` counts to
    have taken ``want_route`` (the tiled GEMM, the quant Group Combine)."""
    before = dict(kernel.routes)
    got = kernel(*args, **kw)
    moved = {r: kernel.routes[r] - before[r] for r in before}
    if moved != {r: int(r == want_route) for r in before}:
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        raise AssertionError(f"{kernel.__name__} {shapes} {args[0].dtype}: routes {moved}, "
                             f"expected {want_route}")
    return got


def quant_combine_case(l, dtype, X, Y, by, gen, shift=False, ties=False):
    """``shift``: the input from a pointer that is not 16-byte aligned;
    ``ties``: small values on a grid of halves and 127 at the first column
    of every K-block, so most ranks' scales are small integers (127 * c *
    f32(1/127) rounds to c) and many quotients land on half-integers, where
    the kernel takes the true division. Returns the calls and the route the
    kernel must take."""
    if ties:
        x = torch.randint(-8, 9, (l.m * X, l.k * Y), device=DEV, generator=gen) / 2.0
        x[:, ::by] = 127.0
        x = x.to(dtype)
    else:
        x = randn(l.m * X, l.k * Y, dtype=dtype, gen=gen)
    if shift:
        x = misaligned(x)
    route = "vector" if not shift and by % (16 // x.element_size()) == 0 else "scalar"
    return (lambda: routed(kernels.group_combine_quant, route, x, l.U, by),
            lambda: ref.group_combine_quant_ref(x, l.U, by), route)


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
    ``by`` as ``kernels.quant_combine.scale_block`` sets it), bit-equal,
    each case on its asserted route: the vector route wherever ``by`` is a
    multiple of 16 bytes of elements, and the scalar one at the ragged
    case, at laderman's and s555's K-blocks, from a misaligned input, and
    on a grid of rounding ties."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    worst = {"group_combine_quant": [0, 0, 0.0], "fused_gemm_combine_h_quant": {}}
    routes = {}
    n = 0
    for l in schemes():
        g = lambda M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
        if tuning.plan_fused_tc(1, 3, 300, 45, l.R, l.m, l.n, by=100).splits < 2:
            raise AssertionError(f"quant case (3, 300, 45, 100) under {l.name} is not split")
        for dtype in (torch.float32, torch.bfloat16):
            # in bf16 also the int8 engine run's leaves (its plain buckets)
            leaves = PROJ_PLANNED + (engine_products()[1] if dtype == torch.bfloat16 else [])
            tiles = sorted({g(*mkn) for mkn in leaves})
            combine = [(37, 75, 25, False, False), (64, 1024, 128, True, False),
                       (16, 256, 128, False, True), (16, 256, 128, True, True)] + [
                (X, Y, scale_block(Y), False, False) for X, Y in sorted(
                    {(X, Y) for X, Y, _ in tiles} | {g(*mkn)[:2] for mkn in PROBES})]
            # ragged, then ragged decode rows with a K-block that is no
            # multiple of 32, split across blocks (S > 1, checked), then the
            # leaves' shapes
            fused = [(37, 75, 45, 25), (3, 300, 45, 100)] + [
                (X, Y, Z, scale_block(Y)) for X, Y, Z in tiles]
            for X, Y, by, shift, ties in combine:
                kfn, pfn, route = quant_combine_case(l, dtype, X, Y, by, gen, shift, ties)
                got = kfn()
                torch.cuda.synchronize()
                dq, flips, ds = check_quant_combine(f"group_combine_quant/{l.name}/{dtype}",
                                                    got, pfn(), QUANT_EXACT)
                n += 1
                routes[(route, str(dtype))] = routes.get((route, str(dtype)), 0) + 1
                emit("kernel_case", kernel="group_combine_quant", scheme=l.name,
                     dtype=str(dtype), X=X, Y=Y, by=by, misaligned=shift, ties=ties,
                     route=route, max_dq=dq, flips=flips, scale_err=ds,
                     tol=[QUANT_EXACT["dq"], QUANT_EXACT["scale"]])
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
    if len(routes) != 4:
        raise AssertionError(f"group_combine_quant: routes by dtype {routes}, expected both "
                             f"routes in both dtypes")
    emit("quant_kernels", cases=n, worst=worst,
         group_combine_quant_routes={f"{r}/{d}": c for (r, d), c in routes.items()})


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
            got = routed(kernels.tiled_matmul, route, a, b)
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


def events_ms(fn, warmup=WARMUP, launches=LAUNCHES, runs=RUNS) -> tuple[float, float]:
    """(device ms, host ms) per call: after ``warmup`` calls, ``runs`` runs
    of ``launches`` back-to-back calls, each between one CUDA event pair
    (device) and one host-clock pair around the enqueueing loop (host);
    medians."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        t1 = time.perf_counter()
        e.record()
        e.synchronize()
        dev.append(s.elapsed_time(e) / launches)
        host.append((t1 - t0) * 1e3 / launches)
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
            a, _, e = check_quant_combine(f"time/{name}", got, pfn(), QUANT_EXACT)
            tol = QUANT_EXACT["scale"]
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
               (M_, 2048, 8192, 1), library=None, plan=quant_plan(a, l.U, by).as_dict())
        aq, as_ = kernels.group_combine_quant(a, l.U, by)
        # torch._int_mm, the int8 product of the logical shape, needs more
        # than 16 rows (a multiple of 8): decode's 4 rows are padded to 24
        a8 = torch.randint(-127, 128, (max(M_, 24), 2048), device=DEV, generator=gen,
                           dtype=torch.int8)
        b8 = torch.randint(-127, 128, (8192, 2048), device=DEV, generator=gen,
                           dtype=torch.int8).t()
        record("fused_gemm_combine_h_quant" + tag,
               lambda: kernels.fused_gemm_combine_h_quant(aq, as_, bq, bs, l.W, out_dtype=bf),
               lambda: ref.fused_gemm_combine_h_quant_ref(aq, as_, bq, bs, l.W, bf),
               2.0 * l.R * X * Y * Z,
               l.R * (X * Y + Y * Z) + 4 * l.R * (X + Z) * (Y // by) + 4 * X * Z * it, fq,
               (M_, 2048, 8192, 1),
               library=lambda: torch._int_mm(a8, b8),
               plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2, by=by)))
    del aq, as_, bq, bs, a8, b8
    # The tune phase's Combine A + int8 probe on its 4096^2 input (probe 3):
    # X = Y = 2048, by 128, bound by bytes
    a = randn(4096, 4096, dtype=bf, gen=gen)
    X = Y = 2048
    by = scale_block(Y)
    record("group_combine_quant@probe3", lambda: kernels.group_combine_quant(a, l.U, by),
           lambda: ref.group_combine_quant_ref(a, l.U, by),
           2.0 * l.nnz_u * X * Y + 2.0 * l.R * X * Y,
           4096 * 4096 * it + l.R * X * Y + 4 * l.R * X * (Y // by), fa,
           (4096, 4096, 4096, 1), library=None, plan=quant_plan(a, l.U, by).as_dict())
    del a
    # The tiled GEMM on the tune path, bf16 on the tensor-core route: its
    # two short-M probes (bound by bytes) and the 4096^3 probe (bound by
    # operations); and decode rows (K split across blocks).
    for (M_, K, N), tag in (((256, 2048, 8192), ""), ((256, 8192, 2048), "@probe2"),
                            ((4096, 4096, 4096), "@4096"), ((4, 2048, 8192), "@decode")):
        a, b = randn(M_, K, dtype=bf, gen=gen), randn(K, N, dtype=bf, gen=gen)
        routed(kernels.tiled_matmul, "wgmma", a, b)
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


def serve(phase: str, cfg, params, quantize: bool = False, batch: int = BATCH,
          prompt: int = PROMPT, gen: int = GEN, **extra) -> tuple[dict, dict]:
    """One full-width one-shot serve through ``run_oneshot``, the launch
    counts set to 0 just before it and read just after. Emits the phase's
    line (with ``extra``'s fields), checks the tokens and logits, returns
    (result, launch counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_oneshot(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=0, device=DEV,
                      params=params, quantize=quantize)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    logits = torch.stack(res["logits"])
    finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all().item())
    tok = res["tokens"]
    emit(phase, **extra, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         mode=cfg.falcon_mode, backend=cfg.falcon_backend, quantize=quantize, batch=batch,
         prompt_len=prompt, new_tokens=gen, n_precombined=res["n_precombined"],
         quantized=res["quantized"],
         **res["timings"], max_memory_allocated=peak, launches=counts,
         launches_by_phase=res["launches"],
         group_combine_by_shape={"x".join(map(str, k)): v
                                 for k, v in kernels.group_combine.shapes.items()},
         logits_finite=finite, sample=tok[0].tolist())
    if not finite or logits.shape[-1] != M.padded_vocab(cfg):
        raise AssertionError(f"{phase}: logits not finite or of the wrong width")
    if tok.shape != (batch, gen) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
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


def per_request(res: dict) -> list[tuple[list[int], list]]:
    """A one-shot run (``run_oneshot``'s result) as (tokens, logits per
    step) per request."""
    return [(res["tokens"][b].tolist(), [lg[b] for lg in res["logits"]])
            for b in range(res["tokens"].shape[0])]


def quality(phase: str, q: list, fp: list, vocab: int) -> float:
    """A serve against fp serving on the same weights and requests, each
    given as (tokens, logits per step) per request: the largest logit error
    over the steps each request's tokens still agree (prefix-matched, as
    tests/test_quant_serve.py), relative to that request's largest fp
    logit. Returns it."""
    row = lambda x: torch.as_tensor(x)[:vocab].float().cpu()  # noqa: E731
    worst, compared, same, total = 0.0, 0, 0, 0
    for (q_tok, q_lg), (f_tok, f_lg) in zip(q, fp, strict=True):
        scale = max(row(lg).abs().max().item() for lg in f_lg)
        n = min(len(q_tok), len(f_tok))
        same += sum(a == b for a, b in zip(q_tok[:n], f_tok[:n]))
        total += n
        for t in range(n):
            if q_tok[:t] != f_tok[:t]:
                break
            d = (row(q_lg[t]) - row(f_lg[t])).abs().max().item()
            worst = max(worst, d / max(scale, 1e-30))
            compared += 1
    emit("quality", of=phase, steps_compared=compared, rel_logit_err=worst,
         tol=QUALITY_TOL, token_agreement=same / total)
    if compared < len(q) or not worst <= QUALITY_TOL:
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
    quality("serve_quant", per_request(res), per_request(fp), cfg.vocab_size)
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
    quality("serve_quant_forced", per_request(res), per_request(fp_forced), cfg.vocab_size)
    del res
    profile_serve("profile_quant_forced", cfg, params, quantize=True)
    del params
    torch.cuda.empty_cache()


def profile_serve(phase: str, cfg, params, quantize: bool = False) -> None:
    """Where the time of serving goes: prefill and one decode step, against
    weights precombined beforehand (outside the window), under
    torch.profiler (:func:`profiled`). Then the same run under cProfile
    (:func:`host_split`)."""
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=quantize)
    with falcon.use(fcfg), torch.inference_mode():
        planned, _ = falcon.precombine_params(params, m_hint=BATCH * PROMPT)
    run = functools.partial(run_oneshot, cfg, batch=BATCH, prompt_len=PROMPT, gen=2,
                            seed=0, device=DEV, params=planned, precombine=False,
                            quantize=quantize)
    res, prof = profiled(run)
    emit(phase, window="prefill + 1 decode step (profiler on)", timings=res["timings"],
         **prof, host=host_split(run))


def profiled(run) -> tuple[object, dict]:
    """``run()`` under torch.profiler: its result, and the wall ms of the
    window, the device ms in it, the share of the window the device was
    busy, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = lambda e: getattr(e, "self_device_time_total", 0)  # noqa: E731
    dev.sort(key=us, reverse=True)
    device_ms = sum(us(e) for e in dev) / 1e3
    return res, {"wall_ms": wall_ms, "device_ms": device_ms if dev else "not measured",
                 "busy_share": device_ms / wall_ms if dev else "not measured",
                 "top": [{"kernel": e.key[:90], "ms": us(e) / 1e3, "calls": e.count}
                         for e in dev[:12]]}


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


# ---------------------------------------------------------------------------
# The continuous-batching engine: each bucket's step a CUDA graph, or eager
# ---------------------------------------------------------------------------

ENGINE_REQUESTS = 16
ENGINE_FP_KERNELS = ("group_combine", "batched_group_combine", "fused_gemm_combine_h",
                     "batched_fused_gemm_combine_h")


def engine_requests(vocab: int) -> list[tuple[np.ndarray, int]]:
    """16 ragged requests drawn as the continuous launcher draws them
    (``launch.serve --continuous``, default_rng(0)): a prompt length in
    [4, 64], its tokens, a budget in [1, 16]."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ENGINE_REQUESTS):
        plen = int(rng.integers(4, ENGINE["max_prompt_len"] + 1))
        prompt = rng.integers(0, vocab, plen)
        out.append((prompt, int(rng.integers(1, ENGINE["max_new_tokens"] + 1))))
    return out


def oneshot_reference(cfg, params, requests) -> list:
    """Each request served alone through the one-shot steps (those of
    ``run_oneshot``), fp, auto mode on h100_sxm (every product on
    torch.matmul): (tokens, logits per step) per request."""
    prefill = make_prefill_step(cfg, ENGINE["max_prompt_len"] + ENGINE["max_new_tokens"])
    decode = make_decode_step(cfg)
    out = []
    with falcon.use(M.falcon_config_for(cfg)), torch.inference_mode():
        for prompt, budget in requests:
            logits, cache = prefill(params, torch.as_tensor(prompt, device=DEV)[None])
            tokens, steps = [], []
            for i in range(budget):
                steps.append(logits[0, -1].float().cpu())
                tokens.append(int(steps[-1].argmax()))
                if i + 1 < budget:
                    logits, _ = decode(params, cache, torch.tensor([[tokens[-1]]], device=DEV),
                                       len(prompt) + i)
            out.append((tokens, steps))
    return out


def engine_run(name: str, cfg, params, requests, cuda_graphs: bool, quantize: bool = False,
               passes: int = 1, profile: bool = True, **kw) -> dict:
    """One ServeEngine at full width: warm (planning, then each bucket's
    warm-up run and capture), the launch counts set to 0, the requests
    served ``passes`` times, the counts read; then (``profile``) 8 requests
    profiled over 4 decode steps (:func:`profile_engine`). Emits the
    ``serve_engine`` and ``profile_engine`` lines; returns the outputs
    (tokens, logits per step, per request and pass), the launch counts and
    the summary."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, params, device=DEV, seed=0, quantize=quantize,
                         cuda_graphs=cuda_graphs, record_logits=True, **ENGINE, **kw)
    spec = bool(kw.get("speculate"))
    if engine.policy != engine_policy(spec) or engine.max_len != engine_keys(spec):
        raise AssertionError(f"serve_engine/{name}: buckets {engine.policy}, cache "
                             f"{engine.max_len}; the kernel cases took {engine_policy(spec)}, "
                             f"{engine_keys(spec)}")
    warm = engine.warm()
    misses = plan_cache.stats().misses
    kernels.reset_launch_counts()
    reqs = []
    for _ in range(passes):
        reqs += [engine.submit(p, max_new_tokens=n) for p, n in requests]
        engine.run()
    state = kernels.launch_state()
    plan_misses = plan_cache.stats().misses - misses
    s = engine.summary()
    steps = s["decode_steps"] + s["verify_steps"]
    out = {"outputs": [(r.generated, r.logits) for r in reqs], "state": state, "summary": s,
           "counts": kernels.launch_counts()}
    emit("serve_engine", config=name, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         mode=cfg.falcon_mode, quantize=quantize, cuda_graphs=s["cuda_graphs"], **kw,
         requests=len(reqs), warm=warm, n_precombined=s["precombined_weights"],
         prefill_ms_per_step=s["t_prefill"] / max(s["prefill_steps"], 1) * 1e3,
         decode_ms_per_step=s["t_decode"] / max(steps, 1) * 1e3,
         tokens_per_s=s["tokens_per_s"], decode_tokens_per_s=s["decode_tokens_per_s"],
         prefill_steps=s["prefill_steps"], decode_steps=s["decode_steps"],
         verify_steps=s["verify_steps"], generated_tokens=s["generated_tokens"],
         bucket_hits=s["bucket_hits"], bucket_misses=s["bucket_misses"],
         plan_misses_after_warm=plan_misses, acceptance_rate=s["acceptance_rate"],
         prefix_hits=s["prefix_hits"], prefix_tokens_reused=s["prefix_tokens_reused"],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=out["counts"],
         sample=reqs[0].generated)
    if plan_misses or s["bucket_misses"] or s["requests_finished"] != len(reqs):
        raise AssertionError(f"serve_engine/{name}: {plan_misses} plan-cache misses after "
                             f"warm, {s['bucket_misses']} bucket misses, "
                             f"{s['requests_finished']}/{len(reqs)} requests finished")
    if engine.graphs.enabled != cuda_graphs or (cuda_graphs and warm["graphs"] == 0):
        raise AssertionError(f"serve_engine/{name}: graphs {warm['graphs']}, asked {cuda_graphs}")
    if profile:
        profile_engine(name, engine, requests)
    del engine, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_engine(name: str, engine, requests) -> None:
    """Where a decode step of the engine goes: 8 requests (full budgets)
    admitted and prefilled, then 4 decode steps under torch.profiler
    (:func:`profiled`), then the step timed without it
    (:func:`time_decode_step`)."""
    new = [engine.submit(p, max_new_tokens=ENGINE["max_new_tokens"]) for p, _ in requests[:8]]
    while len(engine.queue) or any(r.prefilled < r.prompt_len for r in new):
        engine.step()
    steps = engine.stats.decode_steps + engine.stats.verify_steps
    _, prof = profiled(lambda: [engine.step() for _ in range(4)])
    done = engine.stats.decode_steps + engine.stats.verify_steps - steps
    emit("profile_engine", config=name, cuda_graphs=engine.graphs.enabled,
         window=f"{done} decode steps of 8 requests (profiler on)",
         ms_per_step=prof["wall_ms"] / 4, **prof)
    if done != 4:
        raise AssertionError(f"profile_engine/{name}: the window held {done} decode steps")
    time_decode_step(name, engine)
    engine.run()


def time_decode_step(name: str, engine) -> None:
    """The 8-row decode step (a verify round's, speculating) alone, then in
    the engine. ``replay_ms``: CUDA events around 8 back-to-back calls of
    the bucket's step (its graph's replay, or the eager step) on the last
    step's inputs, so each call rewrites the same cache positions with the
    same values; median of 3 runs after one warm-up. ``replay_host_ms``:
    the host's time for the same loop (above ``replay_ms``: the events
    measured the host). Then, unless the engine speculates, its whole decode
    step on the host clock (inputs in, the step, the one synchronization,
    the bookkeeping), alternately with and without the logits copied to the
    host, 4 steps each; ``host_ms``: the step without the copy less the
    replay."""
    step = engine.graphs.steps[("spec", 8) if engine.gamma else ("decode", 8)]
    with falcon.use(engine.fcfg), torch.inference_mode():
        replay, host = events_ms(step, warmup=1, launches=8, runs=3)
    line = {"replay_ms": replay, "replay_host_ms": host}
    if not engine.gamma:
        rows = engine.stats.decode_real_rows
        ms = {True: [], False: []}
        for i in range(8):
            engine.record_logits = i % 2 == 0
            t0 = time.perf_counter()
            engine.step()
            ms[engine.record_logits].append((time.perf_counter() - t0) * 1e3)
        engine.record_logits = True
        if engine.stats.decode_real_rows - rows != 64:
            raise AssertionError(f"decode_step/{name}: the 8 timed steps served "
                                 f"{engine.stats.decode_real_rows - rows} rows, not 8 x 8")
        on, off = statistics.median(ms[True]), statistics.median(ms[False])
        line.update(step_ms_logits=on, step_ms_no_logits=off, logits_copy_ms=on - off,
                    host_ms=off - replay, steps_ms=ms)
    emit("decode_step", config=name, cuda_graphs=engine.graphs.enabled, rows=8, **line)


def phase_serve_engine() -> dict:
    """The continuous-batching ServeEngine on full granite_3_2b, bf16, random
    weights from seed 0, 16 ragged requests: forced strassen fp, forced
    strassen int8 (``--quant``) and auto mode fp, each with every bucket's
    step a CUDA graph and eagerly (``cuda_graphs=False``). The two give
    identical tokens, logits within the bf16 TOL, and equal launch counts
    (the graphs' counted at capture, added per replay); each is held to the
    one-shot fp run of the same requests. Then speculation (γ = 2, identity
    draft) with the prefix cache and 16-token prefill chunks, graphs on,
    serving the requests twice, held to the plain forced engine. Returns
    the launch counts of each graph run."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    base = get_config("granite_3_2b")
    params = M.init_params(base, 0, DEV)
    requests = engine_requests(base.vocab_size)
    fp_ref = oneshot_reference(base, params, requests)
    forced = dataclasses.replace(base, falcon_mode="strassen")
    counts, plain_forced = {}, None
    for name, cfg, quantize in (("forced_fp", forced, False), ("forced_int8", forced, True),
                                ("auto_fp", base, False)):
        runs = {g: engine_run(name, cfg, params, requests, g, quantize)
                for g in (True, False)}
        graph, eager = runs[True], runs[False]
        same = all(g[0] == e[0] for g, e in zip(graph["outputs"], eager["outputs"]))
        diff = max(err(torch.as_tensor(np.stack(g[1])), torch.as_tensor(np.stack(e[1])))[1]
                   for g, e in zip(graph["outputs"], eager["outputs"]))
        emit("serve_engine_check", config=name, identical_tokens=same,
             max_logit_err=diff, tol=TOL[torch.bfloat16]["fused"],
             launches_equal=graph["state"] == eager["state"],
             decode_speedup=eager["summary"]["t_decode"] / graph["summary"]["t_decode"])
        if not same or not diff <= TOL[torch.bfloat16]["fused"]:
            raise AssertionError(f"serve_engine/{name}: graphs and eager steps differ "
                                 f"(identical tokens {same}, logit error {diff})")
        if graph["state"] != eager["state"]:
            raise AssertionError(f"serve_engine/{name}: launches differ: graphs "
                                 f"{dict(graph['state'])}, eager {dict(eager['state'])}")
        want = () if cfg.falcon_mode == "auto" else ENGINE_FP_KERNELS + (
            ("group_combine_quant", "fused_gemm_combine_h_quant") if quantize else ())
        if min((graph["counts"][k] for k in want), default=1) <= 0:
            raise AssertionError(f"serve_engine/{name}: a kernel of the path never launched: "
                                 f"{graph['counts']}")
        quality(f"serve_engine/{name}", graph["outputs"], fp_ref, base.vocab_size)
        counts[name] = graph["counts"]
        if name == "forced_fp":
            plain_forced = graph["outputs"]
        del runs, graph, eager
    spec = engine_run("forced_fp_spec", forced, params, requests, True, passes=2,
                      **ENGINE_SPEC)
    s = spec["summary"]
    if s["prefix_hits"] != ENGINE_REQUESTS or not s["acceptance_rate"] > 0:
        raise AssertionError(f"serve_engine/forced_fp_spec: {s['prefix_hits']} prefix hits, "
                             f"acceptance rate {s['acceptance_rate']}")
    quality("serve_engine/forced_fp_spec", spec["outputs"], plain_forced * 2, base.vocab_size)
    del params, spec
    gc.collect()
    torch.cuda.empty_cache()
    # what the phase leaves allocated (a cuBLAS workspace per stream it ran
    # on stays for the life of the process)
    emit("serve_engine_memory", allocated_before=before,
         allocated_after=torch.cuda.memory_allocated())
    return counts


# ---------------------------------------------------------------------------
# The reference's other dense architectures: decisions, one-shot serving at
# a prefill of 2048 rows, the engine, and the leaves auto mode prices to win
# ---------------------------------------------------------------------------

ARCHS = ("granite_3_2b", "mistral_nemo_12b", "starcoder2_15b", "gemma3_27b")
NEW_ARCHS = ARCHS[1:]
DECISION_M = (4, 256, 2048, 8192)
# One-shot prefill of M = 2048 rows: 4 requests x 512 tokens, or 1 x 2048 for
# gemma3, whose 1024-token window then masks its local layers.
ARCH_SERVE = {"mistral_nemo_12b": (4, 512), "starcoder2_15b": (4, 512),
              "gemma3_27b": (1, 2048)}
ARCH_GEN = 8
LEAF_M = 2048
# The bf16 weights plus the B̃ of every leaf planned at the prefill M must
# fit in this many bytes; the rest of the card's 80 GB holds activations,
# the KV cache, cuBLAS's workspaces and the allocator's slack.
WEIGHT_BUDGET = 68e9


def arch_leaves(arch, lm_head: bool = False) -> dict[str, tuple[int, int]]:
    """(K, N) of each projection ``arch`` (an arch id or a config) plans:
    its static-weight dense contractions, by parameter path, from the
    config's contraction set; with ``lm_head``, the tied LM head's too (a
    runtime product)."""
    out = {}
    for s in workloads.contraction_set(arch):
        if s.kind != "dense" or (s.role == "lm_head" and not lm_head):
            continue
        grp, name = s.role.split(".") if "." in s.role else ("", s.role)
        path = {"attn": f"layers/attn/{name}", "mlp": f"layers/mlp/mlp_{name}"}.get(grp, name)
        out[path] = (s.k, s.n)
    return out


def describe(d) -> str:
    """A decision as the decision lines print it."""
    return f"{d.algo.name}/{d.precision} ({d.speedup:.3f}x)" if d.use_lcma else "gemm"


def phase_decisions() -> None:
    """What auto mode decides on the h100_sxm profile for every leaf of the
    four archs and their LM heads, at M = 4, 256, 2048 and 8192, with and
    without offline Combine B, fp and with the int8 tier."""
    cfg = falcon.FalconConfig()
    for arch in ARCHS:
        for quantize in (False, True):
            c = dataclasses.replace(cfg, quantize=quantize)
            out = {}
            for M_ in DECISION_M:
                for name, (K, N) in arch_leaves(arch, lm_head=True).items():
                    for pre in (False, True):
                        d = falcon.plan(M_, K, N, c, "bfloat16", precombined_b=pre)
                        out[f"M={M_} {name}{' precombined' if pre else ''}"] = describe(d)
            emit("decisions", arch=arch, hardware=cfg.hardware, quantize=quantize,
                 decisions=out)


def planned_leaves(cfg, M_: int) -> dict[str, tuple[int, int, object]]:
    """The leaves auto mode plans an LCMA for at ``M_`` rows under ``cfg``'s
    own policy (h100_sxm, offline Combine B, its backend's pricing): path ->
    (K, N, decision)."""
    fcfg = M.falcon_config_for(cfg)
    out = {}
    for path, (K, N) in arch_leaves(cfg).items():
        d = falcon.plan(M_, K, N, fcfg, cfg.dtype, precombined_b=True)
        if d.use_lcma:
            out[path] = (K, N, d)
    return out


def weight_bytes(cfg, M_: int) -> tuple[int, int, int]:
    """(bytes outside the layers, weight bytes per layer, B̃ bytes per
    layer): bf16 weights, and the B̃ auto mode keeps beside each leaf it
    plans at ``M_`` rows (:func:`planned_leaves`)."""
    it = 2
    raw = 2 * cfg.d_model * it                                  # ln1, ln2
    raw += sum(K * N * it for K, N in arch_leaves(cfg).values())
    bt = sum(d.algo.R * cdiv(K, d.algo.k) * cdiv(N, d.algo.n) * it
             for K, N, d in planned_leaves(cfg, M_).values())
    fixed = (M.padded_vocab(cfg) + 1) * cfg.d_model * it  # embedding, final norm
    return fixed, raw, bt


def fit_depth(cfg, M_: int) -> int:
    """The published depth, or the most layers whose weights and B̃ fit in
    WEIGHT_BUDGET bytes, in whole periods of the layer pattern (gemma3: 5
    local, 1 global), so each kind of layer keeps its published share."""
    fixed, raw, bt = weight_bytes(cfg, M_)
    layers = min(cfg.num_layers, int((WEIGHT_BUDGET - fixed) // (raw + bt)))
    if layers < cfg.num_layers and cfg.global_every:
        layers -= layers % cfg.global_every
    if layers < max(cfg.global_every, 1):
        raise AssertionError(f"{cfg.name}: {layers} layers fit in {WEIGHT_BUDGET} bytes, "
                             f"less than one period of its layer pattern")
    return layers


def arch_served(arch: str) -> tuple[object, list[tuple[str, object]]]:
    """``arch`` as phase serve_archs serves it: the config at its fitted
    depth, and its runs as (name, config): gemm, auto, and for starcoder2
    auto on the generated "torch" backend."""
    full = get_config(arch)
    batch, prompt = ARCH_SERVE[arch]
    base = dataclasses.replace(full, num_layers=fit_depth(full, batch * prompt))
    runs = [("gemm", dataclasses.replace(base, falcon_mode="gemm")), ("auto", base)]
    if arch == "starcoder2_15b":
        runs.append(("auto_torch", dataclasses.replace(base, falcon_backend="torch")))
    return base, runs


def stacked_weight_cases() -> list[tuple[str, int, int, int]]:
    """(scheme, layers, K, N) of each stacked leaf phase serve_archs
    combines offline: precombine_params runs batched_group_combine once over
    all the served layers of every leaf a run plans."""
    out = set()
    for arch in NEW_ARCHS:
        base, runs = arch_served(arch)
        batch, prompt = ARCH_SERVE[arch]
        for _, cfg in runs:
            for K, N, d in planned_leaves(cfg, batch * prompt).values():
                out.add((d.algo.name, base.num_layers, K, N))
    return sorted(out)


def check_stacked_combine(l: LCMA, G: int, K: int, N: int, gen) -> tuple[float, float, list]:
    """batched_group_combine with ``l.V`` over a bf16 stack of G weights
    (G, K, N), a shape the served model gives it, held to the plain version
    one layer at a time (the whole stack's plain version, in f32, would not
    fit beside it). Returns (max abs error, error as :func:`err`, shape)."""
    x = torch.empty(G, l.k * cdiv(K, l.k), l.n * cdiv(N, l.n), dtype=torch.bfloat16,
                    device=DEV)
    for g in range(G):
        x[g] = randn(*x.shape[1:], gen=gen)
    got = kernels.batched_group_combine(x, l.V)
    torch.cuda.synchronize()
    d = scale = 0.0
    for g in range(G):
        want = ref.group_combine_ref(ref.split_blocks(x[g], l.k, l.n), l.V)
        if got[g].shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"batched_group_combine/{l.name}: {got.shape} {got.dtype} "
                                 f"vs plain {want.shape} {want.dtype} per layer")
        d = max(d, (got[g].float() - want.float()).abs().max().item())
        scale = max(scale, want.float().abs().max().item())
        del want
    shape = list(got.shape)
    del x, got
    free_memory()
    return d, d / max(1.0, scale), shape


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def forced_logits(cfg, params, batch: int, prompt: int, tokens: torch.Tensor) -> list:
    """``cfg``'s one-shot serve of :func:`serve`'s prompts (``run_oneshot``'s
    steps and draw, seed 0) with every decode step fed the next token of
    ``tokens`` (batch, gen) instead of its own: the last-position logits of
    the prefill and of each decode step, each (batch, Vp) on the host."""
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)), device=DEV)
    prefill = make_prefill_step(cfg, max_len=prompt + tokens.shape[1])
    decode = make_decode_step(cfg)
    with falcon.use(M.falcon_config_for(cfg)), torch.inference_mode():
        p, _ = falcon.precombine_params(params, m_hint=batch * prompt)
        logits, cache = prefill(p, prompts)
        out = [logits[:, -1].float().cpu()]
        for i in range(tokens.shape[1] - 1):
            logits, _ = decode(p, cache, tokens[:, i:i + 1].to(DEV), prompt + i)
            out.append(logits[:, -1].float().cpu())
    return out


def forced_err(forced: list, fp: dict, vocab: int) -> float:
    """The largest logit error of a teacher-forced run against the fp run
    whose tokens it was fed, over every step of every request, relative to
    that request's largest fp logit."""
    worst = 0.0
    for b in range(fp["tokens"].shape[0]):
        f = torch.stack([lg[b, :vocab].float().cpu() for lg in fp["logits"]])
        q = torch.stack([lg[b, :vocab] for lg in forced])
        worst = max(worst, ((q - f).abs().max() / f.abs().max()).item())
    return worst


def phase_serve_archs() -> None:
    """Each new arch at full width, bf16, random weights from seed 0, served
    one-shot (4 x 512 tokens, gemma3 1 x 2048: a prefill of 2048 rows, then
    8 greedy tokens): auto mode on h100_sxm with backend "cuda" (the leaves
    it plans at M = 2048 precombined, the hand-written kernels at prefill),
    its fp reference with every product on torch.matmul (``gemm``), and for
    starcoder2 the auto run on the generated "torch" backend (priced as it
    runs, H in memory). Depth: the published one where weights and B̃ fit,
    else the most that fit (the ``reduced`` field). Each auto run is held to
    the gemm run within QUALITY_TOL twice: prefix-matched (:func:`quality`)
    and teacher-forced on the gemm run's tokens, which compares every step
    of every request. Each measured serve follows a 2-token warm-up serve
    of the same configuration."""
    for arch in NEW_ARCHS:
        full = get_config(arch)
        batch, prompt = ARCH_SERVE[arch]
        base, run_cfgs = arch_served(arch)
        layers = base.num_layers
        fixed, raw, bt = weight_bytes(base, batch * prompt)
        reduced = ({"num_layers": [full.num_layers, layers]} if layers < full.num_layers
                   else None)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        params = M.init_params(base, 0, DEV)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        emit("serve_archs_weights", arch=arch, reduced=reduced, layers=layers,
             weight_bytes=held, predicted_weight_bytes=fixed + raw * layers,
             predicted_planned_b_bytes=bt * layers, budget=WEIGHT_BUDGET,
             init_transient_bytes=torch.cuda.max_memory_allocated() - before - held,
             planned={path: describe(d) for path, (_, _, d)
                      in planned_leaves(base, batch * prompt).items()})
        common = dict(batch=batch, prompt=prompt, gen=ARCH_GEN, reduced=reduced)
        runs = {}
        for name, cfg in run_cfgs:
            planned = {path: describe(d) for path, (_, _, d)
                       in planned_leaves(cfg, batch * prompt).items()}
            # a warm-up serve first: a model's first calls at new shapes pay
            # for the library's kernel choice and the plan cache's misses
            run_oneshot(cfg, batch=batch, prompt_len=prompt, gen=2, seed=0, device=DEV,
                        params=params)
            free_memory()
            res, counts = serve("serve_archs", cfg, params, config=name, planned=planned,
                                **common)
            runs[name] = res
            served = res["launches"]["prefill"], res["launches"]["decode"]
            if name == "gemm" and (res["n_precombined"] or sum(counts.values())):
                raise AssertionError(f"serve_archs/{arch}/gemm: precombined "
                                     f"{res['n_precombined']}, launches {counts}")
            if name != "gemm" and res["n_precombined"] != len(planned):
                raise AssertionError(f"serve_archs/{arch}/{name}: {res['n_precombined']} "
                                     f"leaves precombined, the pricing names {planned}")
            if name == "auto" and planned and min(served[0][k] for k in (
                    "group_combine", "fused_gemm_combine_h")) <= 0:
                raise AssertionError(f"serve_archs/{arch}/auto: the prefill launched "
                                     f"{served[0]}")
            if name == "auto_torch" and sum(v for p in served for v in p.values()):
                raise AssertionError(f"serve_archs/{arch}/auto_torch: the generated "
                                     f"backend launched kernels {served}")
            if name != "gemm":
                err_ = quality(f"serve_archs/{arch}/{name}", per_request(res),
                               per_request(runs["gemm"]), base.vocab_size)
                free_memory()
                forced = forced_err(forced_logits(cfg, params, batch, prompt,
                                                  runs["gemm"]["tokens"]),
                                    runs["gemm"], base.vocab_size)
                emit("serve_archs_forced", arch=arch, config=name,
                     steps_compared=batch * ARCH_GEN, rel_logit_err=forced, tol=QUALITY_TOL)
                if not forced <= QUALITY_TOL:
                    raise AssertionError(f"serve_archs/{arch}/{name}: teacher-forced logit "
                                         f"error against gemm {forced} > {QUALITY_TOL}")
                emit("serve_archs_vs_gemm", arch=arch, config=name, rel_logit_err=err_,
                     forced_rel_logit_err=forced, tol=QUALITY_TOL,
                     prefill_ms=res["timings"]["prefill_ms"],
                     gemm_prefill_ms=runs["gemm"]["timings"]["prefill_ms"],
                     prefill_speedup=runs["gemm"]["timings"]["prefill_ms"]
                     / res["timings"]["prefill_ms"],
                     decode_ms_per_step=res["timings"]["decode_ms_per_step"],
                     gemm_decode_ms_per_step=runs["gemm"]["timings"]["decode_ms_per_step"],
                     planned=planned, reduced=reduced)
            del res
            free_memory()
        del params, runs
        free_memory()


def phase_serve_engine_archs() -> None:
    """One ServeEngine per new arch at its published depth, auto mode: the
    16 requests of phase serve_engine, every bucket's step a CUDA graph, and
    the same engine eager; identical tokens, logits within the bf16 TOL,
    equal launch counts, no plan-cache miss after warm (both checked in
    :func:`engine_run`). The buckets' M is at most 8 x 64 = 512 rows, where
    auto mode plans every leaf on GEMM: no B̃ is held."""
    for arch in NEW_ARCHS:
        cfg = get_config(arch)
        free_memory()
        params = M.init_params(cfg, 0, DEV)
        requests = engine_requests(cfg.vocab_size)
        runs = {g: engine_run(f"{arch}/auto_fp", cfg, params, requests, g, profile=g)
                for g in (True, False)}
        graph, eager = runs[True], runs[False]
        same = all(g[0] == e[0] for g, e in zip(graph["outputs"], eager["outputs"]))
        diff = max(err(torch.as_tensor(np.stack(g[1])), torch.as_tensor(np.stack(e[1])))[1]
                   for g, e in zip(graph["outputs"], eager["outputs"]))
        emit("serve_engine_check", config=f"{arch}/auto_fp", identical_tokens=same,
             max_logit_err=diff, tol=TOL[torch.bfloat16]["fused"],
             launches_equal=graph["state"] == eager["state"],
             n_precombined=graph["summary"]["precombined_weights"],
             decode_speedup=eager["summary"]["t_decode"] / graph["summary"]["t_decode"])
        if not same or not diff <= TOL[torch.bfloat16]["fused"] \
                or graph["state"] != eager["state"]:
            raise AssertionError(f"serve_engine/{arch}: graphs and eager steps differ "
                                 f"(identical tokens {same}, logit error {diff}, launches "
                                 f"{dict(graph['state'])} vs {dict(eager['state'])})")
        if graph["summary"]["precombined_weights"]:
            raise AssertionError(f"serve_engine/{arch}: {graph['summary']['precombined_weights']}"
                                 f" leaves planned at the buckets' M")
        del params, runs, graph, eager
        free_memory()


def seq_combine_ref(parts: torch.Tensor, coeff: np.ndarray) -> torch.Tensor:
    """The generated code's Group Combine as plain PyTorch: parts (..., d1,
    d2, X, Y) -> (..., R, X, Y), each rank's terms added one at a time in
    the parts' dtype, block (i, l) in row-major order, a coefficient of
    magnitude above 1 applied as its own product first (so in bf16 every
    partial sum rounds, where ``ref.group_combine_ref`` rounds once)."""
    out = []
    for r in range(coeff.shape[0]):
        acc = None
        for i in range(coeff.shape[1]):
            for j in range(coeff.shape[2]):
                c = int(coeff[r, i, j])
                if c == 0:
                    continue
                t = parts[..., i, j, :, :] if abs(c) == 1 else abs(c) * parts[..., i, j, :, :]
                acc = (t if c > 0 else -t) if acc is None else (acc + t if c > 0 else acc - t)
        out.append(torch.zeros_like(parts[..., 0, 0, :, :]) if acc is None else acc)
    return torch.stack(out, dim=-3)


def lcma_plain(a: torch.Tensor, bt: torch.Tensor, l: LCMA, N: int,
               combine=ref.group_combine_ref) -> torch.Tensor:
    """The plain version of the planned path: Combine A (``combine``), the
    product with B̃ and Combine H in f32, one rounding each, reassembled to
    (M, N)."""
    at = combine(ref.split_blocks(a, l.m, l.k), l.U)
    cp = ref.fused_gemm_combine_h_ref(at, bt, l.W)
    return cp.transpose(-3, -2).reshape(a.shape[0], -1)[:, :N]


def phase_leaf_lcma() -> None:
    """Every leaf shape auto mode prices an fp LCMA to win at M = 2048 rows
    (h100_sxm, offline Combine B), bf16: torch.matmul, the "cuda" planned
    path (Group Combine A, then the fused GEMM + Combine H against B̃) and
    the "torch" planned path (the generated combines around one batched
    product, H in f32), each held to its plain version (the "fused" TOL)
    built from a plain B̃ and a plain Combine A: one rounding for "cuda",
    one per added term for "torch" (:func:`seq_combine_ref`, to which the
    generated Combine A is also held at the "combine" TOL), and timed
    (:func:`time_ms`), with each stage of both paths; B̃ (Combine B, the
    kernel) is held to its plain version at the "combine" TOL, and every
    path's error against the f32 product is printed. Beside each measured
    ratio to torch.matmul, the Decision Module's predicted speedup: fused
    (the "cuda" backend's price, the one auto mode took) and unfused (the
    "torch" backend's: H written in f32 and read back)."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    bf = torch.bfloat16
    fcfg = falcon.FalconConfig(use_plan_cache=False)
    tcfg = dataclasses.replace(fcfg, backend="torch")
    torch_backend = falcon.get_backend("torch")
    shapes = {}
    for arch in ARCHS:
        for path, (K, N) in arch_leaves(arch).items():
            d = falcon.plan(LEAF_M, K, N, fcfg, "bfloat16", precombined_b=True)
            if d.use_lcma:
                shapes.setdefault((K, N, d.algo.name), []).append(f"{arch}/{path}")
    if not shapes:
        raise AssertionError("leaf_lcma: auto mode plans no leaf at M = 2048")
    for (K, N, scheme), users in sorted(shapes.items()):
        l = alg.get(scheme)
        a = randn(LEAF_M, K, dtype=bf, gen=gen)
        w = (randn(K, N, gen=gen) / K ** 0.5).to(bf)
        bt = falcon.precombine_weights(w, l)
        bt_plain = ref.group_combine_ref(ref.split_blocks(w, l.k, l.n), l.V)
        errs = {"combine_b": {"vs_plain": err(bt, bt_plain)[1]}}
        if not errs["combine_b"]["vs_plain"] <= TOL[bf]["combine"]:
            raise AssertionError(f"leaf_lcma {(K, N)} {scheme}: B̃ error "
                                 f"{errs['combine_b']['vs_plain']} > {TOL[bf]['combine']}")
        at = kernels.group_combine(a, l.U)
        g = codegen.generate(l, codegen.CodegenOptions(precombined_b=True))
        at_t = g.combine_a(a)
        h = g.stages["gemm"](at_t, bt)
        paths = {"matmul": lambda: torch.matmul(a, w),
                 "cuda": lambda: ops.falcon_matmul_precombined(a, bt, l, N),
                 "torch": lambda: torch_backend.apply_precombined(a, bt, l, N, tcfg)}
        stages = {"cuda/combine_a": lambda: kernels.group_combine(a, l.U),
                  "cuda/fused_gemm_combine_h": lambda: kernels.fused_gemm_combine_h(
                      at, bt, l.W),
                  "torch/combine_a": lambda: g.combine_a(a),
                  "torch/gemm": lambda: g.stages["gemm"](at_t, bt),
                  # the same product with a bf16 result: what keeping H in
                  # f32 costs
                  "torch/gemm_bf16_out": lambda: torch.bmm(at_t, bt),
                  "torch/combine_h": lambda: g.stages["combine_h"](h, bf)}
        plain = {"cuda": lcma_plain(a, bt_plain, l, N),
                 "torch": lcma_plain(a, bt_plain, l, N, seq_combine_ref),
                 "matmul": ref.tiled_matmul_ref(a, w)}
        exact = a.float() @ w.float()
        parts = ref.split_blocks(a, l.m, l.k)
        errs["torch/combine_a"] = {"vs_plain": err(at_t, seq_combine_ref(parts, l.U))[1],
                                   "vs_one_rounding": err(at_t, ref.group_combine_ref(
                                       parts, l.U))[1]}
        if not errs["torch/combine_a"]["vs_plain"] <= TOL[bf]["combine"]:
            raise AssertionError(f"leaf_lcma {(K, N)} {scheme}: generated Combine A error "
                                 f"{errs['torch/combine_a']['vs_plain']} > {TOL[bf]['combine']}")
        for name, fn in paths.items():
            got = fn()
            torch.cuda.synchronize()
            errs[name] = {"vs_plain": err(got, plain[name])[1], "vs_f32": err(got, exact)[1]}
            if not errs[name]["vs_plain"] <= TOL[bf]["fused"]:
                raise AssertionError(f"leaf_lcma {(LEAF_M, K, N)} {scheme} {name}: error "
                                     f"{errs[name]['vs_plain']} > {TOL[bf]['fused']}")
            del got
        del plain, exact, bt_plain, parts
        ms = {name: time_ms(fn) for name, fn in {**paths, **stages}.items()}
        d = falcon.plan(LEAF_M, K, N, fcfg, "bfloat16", precombined_b=True)
        du = falcon.plan(LEAF_M, K, N, tcfg, "bfloat16", precombined_b=True)
        est_u = next(e for e in du.estimates if e.lcma.name == scheme)
        bms, by = bound_ms(2.0 * LEAF_M * K * N, (LEAF_M * K + K * N + LEAF_M * N) * 2,
                           H100_SXM.flops_for("bfloat16"))
        X, Y, Z = cdiv(LEAF_M, l.m), cdiv(K, l.k), cdiv(N, l.n)
        emit("leaf_lcma", M=LEAF_M, K=K, N=N, scheme=scheme, users=users,
             predicted_speedup={"fused": d.speedup, "unfused": du.gemm_seconds / est_u.time},
             measured_speedup={p: ms["matmul"]["ms"] / ms[p]["ms"] for p in ("cuda", "torch")},
             ms={p: t["ms"] for p, t in ms.items()}, source={p: t["source"] for p, t in ms.items()},
             matmul_bound_ms=bms, matmul_bound_by=by, errors=errs, tol=TOL[bf]["fused"],
             fused_plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, l.m, l.n)),
             timing=ms)
        del a, w, bt, at, at_t, h
        free_memory()


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
    """Each planned leaf of the four archs (precombined, as a PlannedWeight
    is priced) at M = 4, 256, 2048 and 8192, fp and int8 tiers, on the data
    sheet and on the calibrated profile side by side: the scheme, precision
    and predicted speedup taken, or for GEMM the best candidate's predicted
    speedup. One line per arch."""
    for arch in ARCHS:
        out = {}
        for quantize in (False, True):
            for M_ in DECISION_M:
                for leaf, (K, N) in arch_leaves(arch).items():
                    row = {}
                    for hw in ("h100_sxm", TUNED):
                        c = falcon.FalconConfig(hardware=hw, quantize=quantize,
                                                use_plan_cache=False)
                        d = falcon.plan(M_, K, N, c, "bfloat16", precombined_b=True)
                        best = min(d.estimates, key=lambda e: e.time, default=None)
                        row[hw] = (describe(d) if d.use_lcma
                                   else f"gemm (best {best.lcma.name}/{best.precision} "
                                        f"{d.gemm_seconds / best.time:.3f}x)" if best
                                   else "gemm (Eq. 8: memory-bound)")
                    out[f"{'int8 tier' if quantize else 'fp'} M={M_} {leaf}"] = row
        emit("decisions_tuned", arch=arch, decisions=out)


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
    worst = quality("serve_tuned", per_request(res), per_request(fp_auto), cfg.vocab_size)
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
    emit("ptxas", kernels={**{name: build.ptxas_report(name)
                              for name in ("tiled_matmul", "group_combine")},
                           "group_combine_quant": [
                               k for k in build.ptxas_report("quant_combine")
                               if "group_combine_quant" in k["kernel"]]})
    phases = {}

    def run(phase, *args):
        """``phase(*args)``, its seconds kept for the ``total`` line."""
        t = time.perf_counter()
        out = phase(*args)
        phases[phase.__name__] = time.perf_counter() - t
        return out

    run(phase_kernels)
    run(phase_quant_kernels)
    run(phase_tiled_kernels)
    run(phase_ops)
    times = run(phase_times)
    run(phase_parity)
    counts, fp_forced = run(phase_serve)
    # each path's kernels count launches from its own run
    quant_counts, fp_auto = run(phase_serve_quant)
    counts.update({k: v for k, v in quant_counts.items() if k.endswith("_quant")})
    run(phase_serve_quant_forced, fp_forced)
    run(phase_serve_engine)
    run(phase_decisions)
    tune_counts, plans = run(phase_tune)
    counts["tiled_matmul"] = tune_counts["tiled_matmul"]
    run(phase_decisions_tuned)
    run(phase_serve_tuned, fp_auto, plans)
    run(phase_leaf_lcma)
    run(phase_serve_archs)
    run(phase_serve_engine_archs)
    emit("total", seconds=time.perf_counter() - t0, phases=phases)
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
