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
ServeEngine at half its published depth, graphs against eager. Offline Combine B
of those leaves (one launch over all served layers) is held to its plain
version layer by layer among the kernel cases. Last, the MoE family at
published width: the expert FFN's calls of #2 (Combine B of whole expert
stacks, Combine A of the activations) and #4 (the grouped product against
per-expert B̃) at dbrx_132b's and kimi_k2_1t's shapes among the kernel
cases and timed beside torch.einsum and torch.bmm; one full-width MoE
layer of each (2048 tokens) in gemm mode and forced strassen, held to its
plain versions and to strassen's static error bound; dbrx served one-shot
(4 x 512 tokens) gemm, auto and forced, at the depth whose weights and B̃
fit (9 of 40 layers), held to gemm prefix-matched and teacher-forced; and
dbrx's ServeEngine at that depth, auto and forced, graphs against eager.
Then the SSM and hybrid families at published width and half their
published depth (mamba2_370m 24 of 48 layers, hymba_1_5b 16 of 32): every call of #1-#4 their phases make among
the kernel cases (the SSD scan's and decode step's grouped contractions in
float32, hymba's attention in bf16), the scan's scores contraction timed
beside torch.bmm; one SSD mixer of each (4 x 2048 tokens) in gemm mode and
forced strassen, held to the plain float32 scan, its four contractions
timed on torch.matmul and on #2/#4 beside the chunk loop; each arch served
one-shot (4 x 2048 tokens, 16 new) gemm, auto and forced, held to gemm
prefix-matched and teacher-forced; and each arch's ServeEngine, auto and
forced, graphs against eager, then with 16-token chunks and with prefix
snapshots. Every comparison of one engine run with another (graphs
against eager, speculation, chunked or prefix-cached prefill against whole
prompts, and the SSM archs' float32 runs) is made at the model's first 8
layers (gemma3: 6), while the graphed runs serve deeper (published depth,
or half of it where the run's time asked for it): what those comparisons
hold does not depend on depth.
Last, the audio and vlm frontends at full width and published depth:
musicgen_large (4 x 512 tokens of 4 codebooks, 16 new) in gemm, auto,
forced strassen (#1/#3 on every projection and each codebook's head, #2/#4
on attention) and forced strassen with the int8 tier (#6/#7, the
codebook-stacked B̃q), and pixtral_12b (4 x (1,024 image patches + 512
tokens), 8 new) in gemm and auto, every call among the kernel cases, each
run held to gemm prefix-matched and teacher-forced; then musicgen, cut to 4
layers, served forced, checkpointed, restored to the card and served again
to the same tokens and logits, and a corrupted payload refused. Then
training: granite_3_2b at full width and published depth (bf16, 4 x 512
tokens, random weights from seed 0) takes 3 AdamW steps through
make_train_step and TrainLoop in gemm, auto and forced strassen, each after
warm_train; every gradient is finite and nonzero, the tied embedding gets
both its shares, auto's and forced's first loss sit within 1% of gemm's,
forced strassen's backward runs #1/#3 and #2/#4 through the planned
autograd cores at checked shapes (each backward call among the kernel
cases); the gradient is held in float32 (granite cut to 4 layers, forced
within 1e-3 of gemm per leaf) and so is mamba2_370m's through the SSD
scan's grouped f32 route (one step at published depth, held at its first 4
layers). Last, multi-device serving on a 1 x 2 mesh whose two ranks are
processes spawned on this one card over gloo (every collective staged
through pinned host memory, so nothing it times is a link's rate): every
call of #1-#4 a rank makes among the kernel cases (granite's shards, dbrx's
8 experts a rank) and timed (``@tp``, ``@ep``); granite_3_2b at full width
and published depth served tensor-parallel (bf16, 4 x 64 tokens, 16 new;
gemm, auto and forced strassen), each held to one-device serving of the
same weights prefix-matched and teacher-forced, and at 2 layers in float32
within 1e-4; the 8-layer ServeEngine on the mesh (eager steps) against the
one-device engine, equal tokens in float32; one full-width dbrx MoE layer
expert-parallel against the one-device layer; and the collective probe on
those ranks. Before it, multi-device training (phase ``train_mesh``):
granite_3_2b at full width, cut to 4 of 40 layers (every collective is
staged), bf16, the 4 x 512 batch, steps 1-3, trained by two ranks on this
card over gloo: on a 2 x 1 mesh with ZeRO-3 over "data" (the published
config's ``fsdp=True``; gemm and forced strassen), in the ``fsdp_only``
style with the ``shard_map_local`` backend (forced) and with the
int8-compressed DP step (gemm); on a 1 x 2 mesh tensor parallel (gemm and
forced; these run in serve_mesh's ranks). Each exact run's losses at
steps 1-3 are held to one device on the same weights and batch, and its
float32 gradient (2 layers) to one device's; the compressed run's step-1
loss, one max all-reduce a step, and its step's float32 gradient bit for
bit to the reference's compressed mean of the ranks' local gradients,
written out apart from the port; every rank's launches of #1-#4 (forward and
backward, ``@fsdp`` / ``@tp_train``) to checked shapes, its m/v bytes to
the reckoning from its shards, and its plan misses after warm_train to 0;
per rank it prints ms a step, tokens/s, peak bytes and the collectives by
operation, forward and backward. The same 2 x 1 ranks then serve granite
over the data axis (``serve_data`` lines: each rank half the rows, one
gather a step; the one-shot at published depth in gemm, auto and forced
strassen, at 2 layers in float32, the 8-layer engine), held to one device
as the 1 x 2 runs are, every launch at a checked shape (``@dp`` cases).
Last, the static tools and the host: ``calibrate_cpu`` on this machine's
host CPU, ``repro_torch.tools.check --all --hardware h100_sxm`` in this
process (it must report 0 errors), and two dry-run cells (granite
``train_4k`` on 16 x 16, kimi_k2_1t ``decode_32k`` on 2 x 16 x 16: rank 0
of a fake process group on the meta device), whose processes start on
the host before the build. Any failure raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is missing. Needs a CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
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
from repro_torch.checkpoint import gather_state, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core.autotune import measure_collective_bw  # noqa: E402
from repro_torch.core.decision import effective_tflops, predicted_effective_tflops  # noqa: E402
from repro_torch.launch.serve import oneshot_inputs, run_oneshot  # noqa: E402
from repro_torch.models import model as M, moe as MOE  # noqa: E402
from repro_torch.parallel import collectives as C, mesh as PM, sharding as SH  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.buckets import BucketPolicy, next_pow2  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig, steps as train_steps  # noqa: E402
from repro_torch.train.steps import (loss_and_grads, make_compressed_dp_train_step,  # noqa: E402
                                     make_decode_step, make_prefill_step, make_train_step,
                                     warm_train)
from repro_torch.core.falcon_gemm import SHARD_MAP_LOCAL  # noqa: E402
from repro_torch.parallel.collectives import all_gather  # noqa: E402

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


def engine_policy(chunked: bool) -> BucketPolicy:
    """The bucket grid ServeEngine builds for ENGINE (and with ENGINE_SPEC's
    chunks): with chunks, prefill buckets top out at the chunk."""
    seq = min(ENGINE["max_prompt_len"], ENGINE_SPEC["prefill_chunk"] if chunked else 1 << 30)
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


# (kernel, input shape) of every launch of #1-#4, #6 and #7 that phases
# kernels and quant_kernels held to its plain version
# (``kernels.launch_state``'s keys): the MoE, SSM and frontend phases fail
# on a launch at any other shape
CHECKED: set = set()
COVERED = ("group_combine", "batched_group_combine", "fused_gemm_combine_h",
           "batched_fused_gemm_combine_h", "group_combine_quant/shape",
           "fused_gemm_combine_h_quant")


def check_covered(phase: str, state) -> None:
    """Fail unless every launch of #1-#4, #6 and #7 in ``state`` (a
    ``kernels.launch_state``) was at a shape the kernel phases checked."""
    miss = sorted(str(k) for k, n in state.items()
                  if isinstance(k, tuple) and k[0] in COVERED and n > 0 and k not in CHECKED)
    if miss:
        raise AssertionError(f"{phase}: launches at shapes no kernel case held to its plain "
                             f"version: {miss}")


def phase_kernels() -> None:
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst, seconds = {}, {}
    n = 0
    kernels.reset_launch_counts()
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
    # The MoE archs' calls at full width (bf16): the expert FFN's Combine B
    # of whole expert stacks, Combine A of the activations and the grouped
    # product against per-expert B̃; dbrx's projections, LM head and
    # attention at every call context
    for name, scheme, fields, check in moe_kernel_cases():
        tol = TOL[torch.bfloat16]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(torch.bfloat16),
             shape=shape, max_abs_err=a, err=e, tol=tol, moe=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/moe {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@moe"] = seconds.get(name + "@moe", 0.0) + time.perf_counter() - t0
    # The SSM and hybrid archs' calls at full width: the SSD contractions in
    # float32, hymba's attention and every projection in bf16
    for name, scheme, dtype, fields, check in ssm_kernel_cases():
        tol = TOL[dtype]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(dtype), shape=shape,
             max_abs_err=a, err=e, tol=tol, ssm=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/ssm {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@ssm"] = seconds.get(name + "@ssm", 0.0) + time.perf_counter() - t0
    # The frontend archs' calls at full width (bf16): musicgen's projections,
    # codebook heads and attention, pixtral's planned leaves at its prefill
    for name, scheme, dtype, fields, check in fe_kernel_cases():
        tol = TOL[dtype]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(dtype), shape=shape,
             max_abs_err=a, err=e, tol=tol, frontend=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/frontend {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@frontend"] = (seconds.get(name + "@frontend", 0.0)
                                       + time.perf_counter() - t0)
    # The train phase's calls (forward, dA and dB of every contraction):
    # granite in bf16 and, cut to GRAD_LAYERS, float32; mamba2 in float32
    for name, scheme, dtype, fields, check in train_kernel_cases():
        tol = TOL[dtype]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(dtype), shape=shape,
             max_abs_err=a, err=e, tol=tol, train=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/train {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@train"] = seconds.get(name + "@train", 0.0) + time.perf_counter() - t0
    # One rank's calls on the mesh of phase serve_mesh: granite's shards
    # (bf16, and float32 at 2 layers), dbrx's 8 experts a rank
    for name, scheme, dtype, fields, check in tp_kernel_cases():
        tol = TOL[dtype]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(dtype), shape=shape,
             max_abs_err=a, err=e, tol=tol, mesh=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/mesh {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@tp"] = seconds.get(name + "@tp", 0.0) + time.perf_counter() - t0
    # One rank's calls in phase train_mesh: granite's local rows against
    # the gathered weights (2 x 1: fsdp, fsdp_only, compressed DP) and its
    # tensor-parallel shards (1 x 2), forward, dA and dB, bf16 and float32
    for name, scheme, dtype, fields, check in train_mesh_kernel_cases():
        tol = TOL[dtype]["fused" if "fused" in name else "combine"]
        t0 = time.perf_counter()
        a, e, shape = check(gen)
        n += 1
        emit("kernel_case", kernel=name, scheme=scheme, dtype=str(dtype), shape=shape,
             max_abs_err=a, err=e, tol=tol, train_mesh=fields)
        if not e <= tol:
            raise AssertionError(f"{name}/{scheme}/train_mesh {fields}: error {e} > {tol}")
        worst[name] = max(worst.get(name, 0.0), e)
        seconds[name + "@train_mesh"] = (seconds.get(name + "@train_mesh", 0.0)
                                         + time.perf_counter() - t0)
    CHECKED.update(k for k in kernels.launch_state() if isinstance(k, tuple))
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
    # musicgen's forced --quant leaves and codebook heads
    fe = check_fe_quant(gen)
    n += 2 * len(fe)
    CHECKED.update(k for k in kernels.launch_state() if isinstance(k, tuple))
    if len(routes) != 4:
        raise AssertionError(f"group_combine_quant: routes by dtype {routes}, expected both "
                             f"routes in both dtypes")
    emit("quant_kernels", cases=n, worst=worst, frontend_tiles=fe,
         group_combine_quant_routes={f"{r}/{d}": c for (r, d), c in routes.items()})


def check_fe_quant(gen) -> list[tuple[int, int, int]]:
    """Both int8 kernels at every tile (X, Y, Z) musicgen's forced --quant
    run gives them (bf16, strassen: each leaf and codebook head at prefill
    and decode), the K-block as its offline B̃q sets it; the quantizing
    Combine A bit-equal on its vector route. Returns the tiles."""
    l = alg.get("strassen")
    fe = sorted({(cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n)) for arch in FE_ARCHS
                 for kind, scheme, _, M_, K, N in (k for k in fe_launches(arch)
                                                    if k[0] == "quant")
                 if scheme == l.name})
    if not fe:
        raise AssertionError("quant_kernels: musicgen's --quant run plans no int8 leaf")
    for X, Y, Z in fe:
        by = scale_block(Y)
        kfn, pfn, route = quant_combine_case(l, torch.bfloat16, X, Y, by, gen)
        got = kfn()
        torch.cuda.synchronize()
        dq, flips, ds = check_quant_combine(f"group_combine_quant/frontend/{(X, Y)}", got,
                                            pfn(), QUANT_EXACT)
        emit("kernel_case", kernel="group_combine_quant", scheme=l.name,
             dtype=str(torch.bfloat16), X=X, Y=Y, by=by, route=route, max_dq=dq, flips=flips,
             scale_err=ds, tol=[QUANT_EXACT["dq"], QUANT_EXACT["scale"]], frontend=True)
        kfn, pfn = fused_quant_case(l, X, Y, Z, by, torch.bfloat16, gen)
        got = kfn()
        torch.cuda.synchronize()
        a, e = err(got, pfn())
        emit("kernel_case", kernel="fused_gemm_combine_h_quant", scheme=l.name,
             dtype=str(torch.bfloat16), X=X, Y=Y, Z=Z, by=by, max_abs_err=a, err=e,
             tol=QUANT_TOL[torch.bfloat16], frontend=True)
        if not e <= QUANT_TOL[torch.bfloat16]:
            raise AssertionError(f"fused_gemm_combine_h_quant/frontend {(X, Y, Z, by)}: "
                                 f"error {e} > {QUANT_TOL[torch.bfloat16]}")
        del got
    return fe


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


def profiler_ms(fn, launches=LAUNCHES) -> float | None:
    """Device ms per call from torch.profiler: the device time of every
    kernel ``launches`` calls ran, over ``launches`` (None if it saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / launches if us > 0 else None


def time_ms(fn, launches=LAUNCHES) -> dict:
    """Time per call of ``fn`` (its operands built beforehand). ``ms`` is the
    events' time over ``launches`` back-to-back launches, unless the host's
    time per call exceeds the device's: then the queue ran dry between
    launches, the events measured the host, and ``ms`` is the profiler's
    device time. ``source`` says which. Calls of many ms take fewer
    launches. Where the host enqueued the launches in under half the
    events' time, the host was the faster side by far and the events
    measured the device: the profiler is not run (``profiler_ms`` None; in
    PR 24's three whole runs no such call had taken the profiler's time)."""
    ev, host = events_ms(fn, launches=launches)
    dev = None if host < 0.5 * ev else profiler_ms(fn, launches)
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

    def record(name, kfn, pfn, flops, nbytes, peak, logical, library="matmul", plan=None,
               launches=LAUNCHES, dtype=bf):
        """Time kernel ``name`` (``name@<tag>`` for a second call shape)
        after checking it once more against its plain version. The library
        yardstick is bf16 ``torch.matmul`` of the logical shape for a
        product kernel, or the ``library`` call where one is given (None:
        none; a Group Combine's computes the same function and is held to
        the plain version too). Kernel, plain version and yardsticks are
        timed alike.
        ``plan``: the kernel's plan for this call as a dict (the tile, ring
        stages and splits of a product kernel; the Group Combine's vector
        width, block and rows), printed on the line. ``launches``: back-to-back
        calls per timed run (fewer for calls of many ms). ``dtype``: the
        operands' (the tolerance's and the yardstick's)."""
        kernel = name.split("@")[0]
        got = kfn()
        torch.cuda.synchronize()
        if kernel == "group_combine_quant":
            a, _, e = check_quant_combine(f"time/{name}", got, pfn(), QUANT_EXACT)
            tol = QUANT_EXACT["scale"]
        else:
            a, e = err(got, pfn())
            tol = (QUANT_TOL[bf] if kernel.endswith("_quant")
                   else TOL[dtype]["combine" if kernel.endswith("group_combine") else "fused"])
            if not e <= tol:
                raise AssertionError(f"time/{name}: error {e} > {tol}")
        del got
        lib_err = None
        if callable(library) and kernel.endswith("group_combine"):
            _, lib_err = err(library(), pfn())      # the same function, checked
            if not lib_err <= tol:
                raise AssertionError(f"time/{name}: library error {lib_err} > {tol}")
        k, plain = time_ms(kfn, launches), time_ms(pfn, launches)
        Mq, Kq, Nq, G = logical
        xa = randn(G, Mq, Kq, dtype=dtype, gen=gen) if G > 1 else randn(Mq, Kq, dtype=dtype, gen=gen)
        xb = randn(G, Kq, Nq, dtype=dtype, gen=gen) if G > 1 else randn(Kq, Nq, dtype=dtype, gen=gen)
        matmul = time_ms(lambda: torch.matmul(xa, xb), launches)
        del xa, xb
        if callable(library):
            lib = time_ms(library, launches)
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
    def same_call(name, measured):
        """``name``'s line: the kernel call ``measured`` timed, the same
        operands (the same shape, scheme and K-block)."""
        out[name] = dict(out[measured], same_call_as=measured)
        emit("time", kernel=name, **out[name])

    # musicgen's codebook heads at decode (forced strassen: one (4, 2048) @
    # (2048, 2048) per codebook, against the codebook-stacked B̃): Combine A
    # (#1) and the quantizing Combine A (#6) are the calls of a K = 2048
    # leaf at decode, timed above; the fused product (#3) and, with --quant,
    # the int8 product (#7) against the stacked B̃q
    d, Vp, rows = 2048, 2048, 4
    X, Y, Z = rows // 2, d // 2, Vp // 2
    a = randn(rows, d, dtype=bf, gen=gen)
    same_call("group_combine@codebook_head", "group_combine@decode_a")
    at = kernels.group_combine(a, l.U)
    bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
    record("fused_gemm_combine_h@codebook_head",
           lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
           2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx, (rows, d, Vp, 1),
           plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2)))
    by = scale_block(Y)
    bq, bs = kernels.quantize_b_blockwise(randn(d, Vp, dtype=bf, gen=gen), l.V, by)
    same_call("group_combine_quant@codebook_head", "group_combine_quant@decode")
    aq, as_ = kernels.group_combine_quant(a, l.U, by)
    a8 = torch.randint(-127, 128, (24, d), device=DEV, generator=gen, dtype=torch.int8)
    b8 = torch.randint(-127, 128, (Vp, d), device=DEV, generator=gen, dtype=torch.int8).t()
    record("fused_gemm_combine_h_quant@codebook_head",
           lambda: kernels.fused_gemm_combine_h_quant(aq, as_, bq, bs, l.W, out_dtype=bf),
           lambda: ref.fused_gemm_combine_h_quant_ref(aq, as_, bq, bs, l.W, bf),
           2.0 * l.R * X * Y * Z,
           l.R * (X * Y + Y * Z) + 4 * l.R * (X + Z) * (Y // by) + 4 * X * Z * it, fq,
           (rows, d, Vp, 1), library=lambda: torch._int_mm(a8, b8),
           plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2, by=by)))
    del a, at, bt, bq, bs, aq, as_, a8, b8
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
    # The MoE expert FFN (dbrx, forced strassen): Combine B of the gate/up
    # expert stack (16, 6144, 10752), which runs at every call, and Combine A
    # of its activations at the prefill's capacity C = 768 (#2); the grouped
    # fused GEMM against the per-expert B̃ at C = 768 and at decode, C = 8
    # (#4), with torch.bmm of the same R*G products as its library call.
    cfg = get_config("dbrx_132b")
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    for tag, (rows, cols), coeff, nnz, C in (("@moe_b", (d, ff), l.V, l.nnz_v, 768),
                                              ("@moe_a", (768, d), l.U, l.nnz_u, 768)):
        x3 = randn(E, rows, cols, dtype=bf, gen=gen)
        X, Y = rows // 2, cols // 2
        record("batched_group_combine" + tag, lambda: kernels.batched_group_combine(x3, coeff),
               lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), coeff),
               E * 2.0 * nnz * X * Y, E * (4 + l.R) * X * Y * it, fa, (C, d, ff, E),
               library=combine_library(x3, coeff), plan=launch_plan(x3, coeff).as_dict(),
               launches=5)
        del x3
        free_memory()
    for tag, C in (("@moe", 768), ("@moe_decode", 8)):
        X, Y, Z = C // 2, d // 2, ff // 2
        at4 = randn(E, l.R, X, Y, dtype=bf, gen=gen)
        bt4 = torch.empty(E, l.R, Y, Z, dtype=bf, device=DEV)
        for g in range(E):
            bt4[g] = randn(l.R, Y, Z, dtype=bf, gen=gen)
        record("batched_fused_gemm_combine_h" + tag,
               lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
               lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
               E * 2.0 * l.R * X * Y * Z, E * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
               (C, d, ff, E),
               library=lambda: torch.bmm(at4.view(E * l.R, X, Y), bt4.view(E * l.R, Y, Z)),
               plan=fused_plan(tuning.plan_fused_tc(E, X, Y, Z, l.R, 2, 2)), launches=5)
        del at4, bt4
        free_memory()
    # The SSD scan's scores contraction (mamba2, 4 x 2048 tokens: G = 4 x 8
    # chunks x 32 heads = 1,024 groups of (256, 128) @ (128, 256), forced
    # strassen, float32, the SIMT route): Combine A of C (#2) and the
    # grouped product against per-group B̃ (#4), with torch.bmm of the same
    # 7,168 products as its library call
    f32, it32 = torch.float32, 4
    cfg = get_config("mamba2_370m")
    c, N = cfg.ssm_chunk, cfg.ssm_state
    G = SSM_SERVE[0] * cdiv(SSM_SERVE[1], c) * cfg.ssm_heads
    x3 = randn(G, c, N, dtype=f32, gen=gen)
    X, Y, Z = c // 2, N // 2, c // 2
    record("batched_group_combine@ssd", lambda: kernels.batched_group_combine(x3, l.U),
           lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.U),
           G * 2.0 * l.nnz_u * X * Y, G * (4 + l.R) * X * Y * it32, fa, (c, N, c, G),
           library=combine_library(x3, l.U), plan=launch_plan(x3, l.U).as_dict(), dtype=f32)
    del x3
    at4 = randn(G, l.R, X, Y, dtype=f32, gen=gen)
    bt4 = randn(G, l.R, Y, Z, dtype=f32, gen=gen)
    bx, bz, bk = tuning.plan_fused_gemm_blocks(X, 2, 2)
    record("batched_fused_gemm_combine_h@ssd",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it32, fa,
           (c, N, c, G),
           library=lambda: torch.bmm(at4.view(G * l.R, X, Y), bt4.view(G * l.R, Y, Z)),
           plan={"route": "simt", "bx": bx, "bz": bz, "bk": bk}, dtype=f32, launches=10)
    del at4, bt4
    free_memory()
    # Training (granite, forced strassen, bf16): the backward of mlp_up, its
    # largest leaf (2048 x 2048 -> 8192). dA = g (2048, 8192) @ w.T (8192,
    # 2048): Combine A of g and the product (1024, 4096, 1024); dB = a.T
    # (2048, 2048) @ g (2048, 8192): Combine B of g and the product (1024,
    # 1024, 4096). Attention (128 groups, 512 queries and keys): the scores'
    # dA = g (512, 512) @ k (512, 64), Combine A of g (#2) and the grouped
    # product (#4), with torch.bmm of the same products as its library call.
    g2 = randn(2048, 8192, dtype=bf, gen=gen)
    X, Y = 1024, 4096
    for tag, coeff, nnz, mkn in (("@train_dA", l.U, l.nnz_u, (2048, 8192, 2048)),
                                 ("@train_dB", l.V, l.nnz_v, (2048, 2048, 8192))):
        record("group_combine" + tag, lambda: kernels.group_combine(g2, coeff),
               lambda: ref.group_combine_ref(ref.split_blocks(g2, 2, 2), coeff),
               2.0 * nnz * X * Y, (4 + l.R) * X * Y * it, fa, (*mkn, 1),
               library=combine_library(g2, coeff), plan=launch_plan(g2, coeff).as_dict())
    del g2
    for tag, (X, Y, Z) in (("@train_dA", (1024, 4096, 1024)), ("@train_dB", (1024, 1024, 4096))):
        at = randn(l.R, X, Y, dtype=bf, gen=gen)
        bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
        record("fused_gemm_combine_h" + tag, lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
               lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
               2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
               (2 * X, 2 * Y, 2 * Z, 1),
               plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2)), launches=10)
        del at, bt
    G, Sq = 128, TRAIN[1]
    g3 = randn(G, Sq, Sq, dtype=bf, gen=gen)
    X = Y = Sq // 2
    record("batched_group_combine@train_attn", lambda: kernels.batched_group_combine(g3, l.U),
           lambda: ref.group_combine_ref(ref.split_blocks(g3, 2, 2), l.U),
           G * 2.0 * l.nnz_u * X * Y, G * (4 + l.R) * X * Y * it, fa, (Sq, Sq, 64, G),
           library=combine_library(g3, l.U), plan=launch_plan(g3, l.U).as_dict())
    del g3
    X, Y, Z = Sq // 2, Sq // 2, 32
    at4 = randn(G, l.R, X, Y, dtype=bf, gen=gen)
    bt4 = randn(G, l.R, Y, Z, dtype=bf, gen=gen)
    record("batched_fused_gemm_combine_h@train_attn",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (Sq, Sq, 64, G),
           library=lambda: torch.bmm(at4.view(G * l.R, X, Y), bt4.view(G * l.R, Y, Z)),
           plan=fused_plan(tuning.plan_fused_tc(G, X, Y, Z, l.R, 2, 2)), launches=10)
    del at4, bt4
    free_memory()
    # One rank's calls on phase serve_mesh's 1 x 2 mesh (granite, forced
    # strassen): the tied LM head's vocab shard (2048, 24704) through Combine
    # B at every call (#1), the mlp_up shard at prefill (256, 2048) @ (2048,
    # 4096) (#3), attention over the rank's 16 heads at prefill (64 groups
    # of (64, 64) @ (64, 80)): Combine A of q (#2) and the scores product
    # (#4); dbrx's expert-parallel layer at 8 experts a rank: Combine B of
    # the gate/up stack's shard (8, 6144, 10752) (#2) and the grouped product
    # at C = 768 against per-expert B̃ (#4).
    x = randn(2048, 24704, dtype=bf, gen=gen)
    X, Y = 1024, 12352
    record("group_combine@tp", lambda: kernels.group_combine(x, l.V),
           lambda: ref.group_combine_ref(ref.split_blocks(x, 2, 2), l.V),
           2.0 * l.nnz_v * X * Y, (4 + l.R) * X * Y * it, fa, (256, 2048, 24704, 1),
           library=combine_library(x, l.V), plan=launch_plan(x, l.V).as_dict())
    del x
    x3 = randn(64, 64, 64, dtype=bf, gen=gen)
    X, Y = 32, 32
    record("batched_group_combine@tp", lambda: kernels.batched_group_combine(x3, l.U),
           lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.U),
           64 * 2.0 * l.nnz_u * X * Y, 64 * (4 + l.R) * X * Y * it, fa, (64, 64, 80, 64),
           library=combine_library(x3, l.U), plan=launch_plan(x3, l.U).as_dict())
    del x3
    X, Y, Z = 128, 1024, 2048
    at = randn(l.R, X, Y, dtype=bf, gen=gen)
    bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
    record("fused_gemm_combine_h@tp", lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
           2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (256, 2048, 4096, 1), plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2)))
    del at, bt
    G, X, Y, Z = 64, 32, 32, 40
    at4 = randn(G, l.R, X, Y, dtype=bf, gen=gen)
    bt4 = randn(G, l.R, Y, Z, dtype=bf, gen=gen)
    record("batched_fused_gemm_combine_h@tp",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (64, 64, 80, G), plan=fused_plan(tuning.plan_fused_tc(G, X, Y, Z, l.R, 2, 2)))
    del at4, bt4
    cfg = get_config(MESH_MOE)
    E, d, ff = cfg.num_experts // MESH["model"], cfg.d_model, cfg.d_ff
    C = mesh_moe_capacity(cfg)
    x3 = randn(E, d, ff, dtype=bf, gen=gen)
    X, Y = d // 2, ff // 2
    record("batched_group_combine@ep", lambda: kernels.batched_group_combine(x3, l.V),
           lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.V),
           E * 2.0 * l.nnz_v * X * Y, E * (4 + l.R) * X * Y * it, fa, (C, d, ff, E),
           library=combine_library(x3, l.V), plan=launch_plan(x3, l.V).as_dict(), launches=5)
    del x3
    free_memory()
    X, Y, Z = C // 2, d // 2, ff // 2
    at4 = randn(E, l.R, X, Y, dtype=bf, gen=gen)
    bt4 = torch.empty(E, l.R, Y, Z, dtype=bf, device=DEV)
    for g in range(E):
        bt4[g] = randn(l.R, Y, Z, dtype=bf, gen=gen)
    record("batched_fused_gemm_combine_h@ep",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           E * 2.0 * l.R * X * Y * Z, E * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (C, d, ff, E),
           library=lambda: torch.bmm(at4.view(E * l.R, X, Y), bt4.view(E * l.R, Y, Z)),
           plan=fused_plan(tuning.plan_fused_tc(E, X, Y, Z, l.R, 2, 2)), launches=5)
    del at4, bt4
    free_memory()
    # One rank's calls in phase train_mesh (granite, forced strassen, bf16):
    # ``@fsdp``, the 2 x 1 mesh's local rows (1,024 = 2 x 512) against the
    # gathered weight: Combine A of mlp_up's input (1024, 2048) (#1) and its
    # product (1024, 2048) @ (2048, 8192) (#3), attention over the rank's
    # 64 head groups (2 rows x 32 heads): Combine A of q (#2) and the scores
    # product (#4); ``@tp_train``, the 1 x 2 mesh's shards in backward:
    # mlp_up's dA, Combine A of g (2048, 4096) (#1) and g @ w_shard.T
    # (2048, 4096) @ (4096, 2048) (#3), and the scores' dA over the rank's
    # 64 groups (4 rows x 16 heads): Combine A of g (64, 512, 512) (#2) and
    # the product against k (#4).
    for tag, (rows, cols), mkn in (("@fsdp", (1024, 2048), (1024, 2048, 8192)),
                                   ("@tp_train", (2048, 4096), (2048, 4096, 2048))):
        x = randn(rows, cols, dtype=bf, gen=gen)
        X, Y = rows // 2, cols // 2
        record("group_combine" + tag, lambda: kernels.group_combine(x, l.U),
               lambda: ref.group_combine_ref(ref.split_blocks(x, 2, 2), l.U),
               2.0 * l.nnz_u * X * Y, (4 + l.R) * X * Y * it, fa, (*mkn, 1),
               library=combine_library(x, l.U), plan=launch_plan(x, l.U).as_dict())
        del x
    for tag, (X, Y, Z) in (("@fsdp", (512, 1024, 4096)), ("@tp_train", (1024, 2048, 1024))):
        at = randn(l.R, X, Y, dtype=bf, gen=gen)
        bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
        record("fused_gemm_combine_h" + tag, lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
               lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
               2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
               (2 * X, 2 * Y, 2 * Z, 1),
               plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, 2, 2)), launches=10)
        del at, bt
    G = 64
    for tag, (Sq, K), logical in (("@fsdp", (512, 64), (512, 64, 512, G)),
                                  ("@tp_train", (512, 512), (512, 512, 64, G))):
        x3 = randn(G, Sq, K, dtype=bf, gen=gen)
        X, Y = Sq // 2, K // 2
        record("batched_group_combine" + tag, lambda: kernels.batched_group_combine(x3, l.U),
               lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.U),
               G * 2.0 * l.nnz_u * X * Y, G * (4 + l.R) * X * Y * it, fa, logical,
               library=combine_library(x3, l.U), plan=launch_plan(x3, l.U).as_dict())
        del x3
    for tag, (X, Y, Z), logical in (("@fsdp", (256, 32, 256), (512, 64, 512, G)),
                                    ("@tp_train", (256, 256, 32), (512, 512, 64, G))):
        at4 = randn(G, l.R, X, Y, dtype=bf, gen=gen)
        bt4 = randn(G, l.R, Y, Z, dtype=bf, gen=gen)
        record("batched_fused_gemm_combine_h" + tag,
               lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
               lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
               G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
               logical,
               library=lambda: torch.bmm(at4.view(G * l.R, X, Y), bt4.view(G * l.R, Y, Z)),
               plan=fused_plan(tuning.plan_fused_tc(G, X, Y, Z, l.R, 2, 2)), launches=10)
        del at4, bt4
    free_memory()
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
          prompt: int = PROMPT, gen: int = GEN, seed: int = 0, **extra) -> tuple[dict, dict]:
    """One full-width one-shot serve through ``run_oneshot`` (prompts drawn
    from ``seed``), the launch counts set to 0 just before it and read just
    after. Emits the phase's line (with ``extra``'s fields), checks the
    tokens and logits, returns (result, launch counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_oneshot(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=seed, device=DEV,
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
         batched_group_combine_by_shape={"x".join(map(str, k)): v for k, v in
                                         kernels.batched_group_combine.shapes.items()},
         logits_finite=finite, sample=tok[0].tolist())
    if not finite or logits.shape[-1] != M.padded_vocab(cfg):
        raise AssertionError(f"{phase}: logits not finite or of the wrong width")
    codebooks = (cfg.num_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    if tok.shape != (batch, gen, *codebooks) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
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
    logit (:func:`logit_error`), held to QUALITY_TOL. Returns it."""
    worst, compared, agreement = logit_error(q, fp, vocab)
    emit("quality", of=phase, steps_compared=compared, rel_logit_err=worst,
         tol=QUALITY_TOL, token_agreement=agreement)
    if compared < len(q) or not worst <= QUALITY_TOL:
        raise AssertionError(f"{phase}: logit error against fp {worst} over {compared} "
                             f"steps (tolerance {QUALITY_TOL})")
    return worst


def logit_error(q: list, fp: list, vocab: int) -> tuple[float, int, float]:
    """(largest prefix-matched relative logit error, steps compared, share
    of equal tokens) of ``q`` against ``fp``, as :func:`quality` reads them.
    An audio step's logits (CB, Vp) are compared over every codebook."""
    row = lambda x: torch.as_tensor(x)[..., :vocab].float().cpu()  # noqa: E731
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
    return worst, compared, same / total


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
    ``run_oneshot``), fp, in ``cfg``'s mode (granite's auto on h100_sxm
    puts every product on torch.matmul): (tokens, logits per step) per
    request."""
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
    spec, chunked = bool(kw.get("speculate")), bool(kw.get("prefill_chunk"))
    if engine.policy != engine_policy(chunked) or engine.max_len != engine_keys(spec):
        raise AssertionError(f"serve_engine/{name}: buckets {engine.policy}, cache "
                             f"{engine.max_len}; the kernel cases took "
                             f"{engine_policy(chunked)}, {engine_keys(spec)}")
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
           "counts": kernels.launch_counts(),
           # the real slots' recurrent state (SSM and hybrid) as the requests left it
           "slot_state": engine.cache["state"][:, :engine.max_slots].clone()
           if "state" in engine.cache else None}
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


# Graphs against eager (and chunked or prefix-cached against whole prefill)
# at the first layers: what these comparisons hold does not depend on the
# depth, and eager steps at published depth took most of the engine phases'
# time
TWIN_LAYERS = 8


def twin_depth(cfg) -> int:
    """TWIN_LAYERS, in whole periods of the layer pattern (gemma3: 6)."""
    p = cfg.global_every or 1
    return min(cfg.num_layers, max(p, TWIN_LAYERS - TWIN_LAYERS % p))


def cut_depth(cfg, params, layers: int):
    """``cfg`` and ``params`` cut to their first ``layers`` layers (the
    stacked leaves sliced, no copy)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[:layers]
    return dataclasses.replace(cfg, num_layers=layers), {**params, "layers": take(params["layers"])}


def twin_check(name: str, cfg, params, requests, quantize: bool = False) -> dict:
    """The engine of ``cfg`` at its first :func:`twin_depth` layers, every
    bucket's step a CUDA graph and the same engine eager: identical tokens,
    logits within the bf16 TOL, equal launch counts and (SSM, hybrid) the
    real slots' recurrent state bit-equal. Returns the two runs (graphs,
    eager)."""
    c, p = cut_depth(cfg, params, twin_depth(cfg))
    tag = f"{name}@{c.num_layers}L"
    graph, eager = (engine_run(tag, c, p, requests, g, quantize, profile=False)
                    for g in (True, False))
    same = all(g[0] == e[0] for g, e in zip(graph["outputs"], eager["outputs"]))
    diff = max(err(torch.as_tensor(np.stack(g[1])), torch.as_tensor(np.stack(e[1])))[1]
               for g, e in zip(graph["outputs"], eager["outputs"]))
    same_state = graph["slot_state"] is None or torch.equal(graph["slot_state"],
                                                             eager["slot_state"])
    emit("serve_engine_check", config=tag, layers=c.num_layers, identical_tokens=same,
         max_logit_err=diff, tol=TOL[torch.bfloat16]["fused"], slot_state_bit_equal=same_state,
         launches_equal=graph["state"] == eager["state"],
         n_precombined=graph["summary"]["precombined_weights"],
         decode_speedup=eager["summary"]["t_decode"] / graph["summary"]["t_decode"])
    if not same or not same_state or not diff <= TOL[torch.bfloat16]["fused"] \
            or graph["state"] != eager["state"]:
        raise AssertionError(f"serve_engine/{tag}: graphs and eager differ (identical tokens "
                             f"{same}, slot state bit-equal {same_state}, logit error {diff}, "
                             f"launches {dict(graph['state'])} vs {dict(eager['state'])})")
    return graph, eager


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
    step a CUDA graph, held to the one-shot fp run of the same requests;
    then each at the model's first TWIN_LAYERS layers with graphs and
    eagerly (``cuda_graphs=False``), which give identical tokens, logits
    within the bf16 TOL, and equal launch counts (the graphs' counted at
    capture, added per replay: :func:`twin_check`). Then, at those layers,
    speculation (γ = 2, identity draft) with the prefix cache and 16-token
    prefill chunks, graphs on, serving the requests twice, held to the
    plain forced engine. Returns the launch counts of each graph run."""
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
        graph = engine_run(name, cfg, params, requests, True, quantize)
        twin, _ = twin_check(name, cfg, params, requests, quantize)
        want = () if cfg.falcon_mode == "auto" else ENGINE_FP_KERNELS + (
            ("group_combine_quant", "fused_gemm_combine_h_quant") if quantize else ())
        if min((graph["counts"][k] for k in want), default=1) <= 0:
            raise AssertionError(f"serve_engine/{name}: a kernel of the path never launched: "
                                 f"{graph['counts']}")
        quality(f"serve_engine/{name}", graph["outputs"], fp_ref, base.vocab_size)
        counts[name] = graph["counts"]
        if name == "forced_fp":
            plain_forced = twin["outputs"]
        del graph, twin
    # speculation against the plain engine, at the first layers
    cut, cut_params = cut_depth(forced, params, twin_depth(forced))
    spec = engine_run(f"forced_fp_spec@{cut.num_layers}L", cut, cut_params, requests, True,
                      passes=2, profile=False, **ENGINE_SPEC)
    s = spec["summary"]
    if s["prefix_hits"] != ENGINE_REQUESTS or not s["acceptance_rate"] > 0:
        raise AssertionError(f"serve_engine/forced_fp_spec: {s['prefix_hits']} prefix hits, "
                             f"acceptance rate {s['acceptance_rate']}")
    quality("serve_engine/forced_fp_spec", spec["outputs"], plain_forced * 2, base.vocab_size)
    del params, cut_params, spec
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
        path = {"attn": f"layers/attn/{name}", "mlp": f"layers/mlp/mlp_{name}",
                "ssm": f"layers/ssm/ssm_{name.removesuffix('_proj')}"}.get(grp, name)
        out[path] = (s.k, s.n)
    return out


def describe(d) -> str:
    """A decision as the decision lines print it."""
    return f"{d.algo.name}/{d.precision} ({d.speedup:.3f}x)" if d.use_lcma else "gemm"


def phase_decisions() -> None:
    """What auto mode decides on the h100_sxm profile for every leaf of the
    four dense archs and the two MoE archs and their LM heads, and the MoE
    archs' grouped expert projections, at M = 4, 256, 2048 and 8192, with
    and without offline Combine B, fp and with the int8 tier."""
    cfg = falcon.FalconConfig()
    for arch in ARCHS + MOE_ARCHS:
        for quantize in (False, True):
            c = dataclasses.replace(cfg, quantize=quantize)
            out = {}
            for M_ in DECISION_M:
                for name, (K, N) in arch_leaves(arch, lm_head=True).items():
                    for pre in (False, True):
                        d = falcon.plan(M_, K, N, c, "bfloat16", precombined_b=pre)
                        out[f"M={M_} {name}{' precombined' if pre else ''}"] = describe(d)
                # the expert FFN: one grouped decision per projection shape at
                # the capacity the layer serves M_ rows with (the runtime
                # path, Combine B priced; precombined: a planned 3-D stack)
                for E, C, K, N in workloads.grouped_moe_shapes(arch, M_):
                    for pre in (False, True):
                        d = falcon.plan_batched(E, C, K, N, c, "bfloat16", precombined_b=pre)
                        out[f"M={M_} experts g{E}x{C}x{K}x{N}"
                            f"{' precombined' if pre else ''}"] = describe(d)
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
    """(scheme, layers, K, N) of each stacked leaf phases serve_archs,
    serve_moe and serve_engine_moe combine offline: precombine_params runs
    batched_group_combine once over all the served layers of every leaf a
    run plans (dbrx: auto's leaves, and forced strassen's w_q..w_o; its 4-D
    expert stacks stay raw)."""
    out = set()
    for arch in NEW_ARCHS:
        base, runs = arch_served(arch)
        batch, prompt = ARCH_SERVE[arch]
        for _, cfg in runs:
            for K, N, d in planned_leaves(cfg, batch * prompt).values():
                out.add((d.algo.name, base.num_layers, K, N))
    base, _, _ = moe_served()
    out |= {("strassen", base.num_layers, K, N) for K, N in arch_leaves(base).values()}
    out |= {(d.algo.name, base.num_layers, K, N)
            for K, N, d in planned_leaves(base, MOE_SERVE[0] * MOE_SERVE[1]).values()}
    return sorted(out)


def check_stacked_combine(l: LCMA, G: int, K: int, N: int, gen,
                          dtype=torch.bfloat16) -> tuple[float, float, list]:
    """batched_group_combine with ``l.V`` over a stack of G weights (G, K, N)
    in ``dtype``, a shape the served model gives it, held to the plain
    version one layer at a time (the whole stack's plain version, in f32,
    would not fit beside it). Returns (max abs error, error as :func:`err`,
    shape)."""
    x = torch.empty(G, l.k * cdiv(K, l.k), l.n * cdiv(N, l.n), dtype=dtype, device=DEV)
    for g in range(G):
        x[g] = randn(*x.shape[1:], dtype=dtype, gen=gen)
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


def forced_logits(cfg, params, batch: int, prompt: int, tokens: torch.Tensor,
                  seed: int = 0, quantize: bool = False, mesh_shape: dict | None = None) -> list:
    """``cfg``'s one-shot serve of :func:`serve`'s prompts (``run_oneshot``'s
    steps and draw from ``seed``: an audio model's codebook tokens, a vlm's
    patches) with every decode step fed the next token of ``tokens`` (batch,
    gen[, CB]) instead of its own: the last-position logits of the prefill
    and of each decode step, each (batch[, CB], Vp) on the host. With
    ``mesh_shape``, on this rank of its mesh (``params`` sharded here); over
    a data axis the rank runs its rows, as ``run_oneshot`` does, and each
    step's logits are gathered over "data"."""
    prompts, patches, pos0 = oneshot_inputs(cfg, batch, prompt, seed, DEV)
    prefill = make_prefill_step(cfg, max_len=pos0 + tokens.shape[1])
    decode = make_decode_step(cfg)
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=quantize)
    mesh = PM.mesh_for(mesh_shape)
    if mesh is not None:
        params = SH.shard_params(params, cfg, mesh)
    data = 1 if mesh is None else mesh.size("data")
    if data > 1:
        _, mine = mesh.data_rows(batch)
        prompts, tokens = prompts[mine], tokens[mine]
        patches = None if patches is None else patches[mine]

    def last(logits):
        lg = logits[:, -1]
        if data > 1:
            lg = C.all_gather_rows({"logits": lg}, mesh, "data")["logits"]
        return lg.float().cpu()

    with falcon.use(fcfg), PM.use_mesh(mesh), MOE.route_over_data(batch), \
            torch.inference_mode():
        p, _ = falcon.precombine_params(params, m_hint=batch * prompt)
        logits, cache = prefill(p, prompts, patches)
        out = [last(logits)]
        for i in range(tokens.shape[1] - 1):
            logits, _ = decode(p, cache, tokens[:, i:i + 1].to(DEV), pos0 + i)
            out.append(last(logits))
    return out


def forced_err(forced: list, fp: dict, vocab: int) -> float:
    """The largest logit error of a teacher-forced run against the fp run
    whose tokens it was fed, over every step of every request, relative to
    that request's largest fp logit (an audio step's over every codebook)."""
    worst = 0.0
    for b in range(fp["tokens"].shape[0]):
        f = torch.stack([lg[b][..., :vocab].float().cpu() for lg in fp["logits"]])
        q = torch.stack([lg[b][..., :vocab] for lg in forced])
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


# The depth phase serve_engine_archs serves at: half the published depth
# (40, 40, 62 layers; gemma3 in whole 6-layer periods), to make room in the
# run's time for phase serve_mesh
ENGINE_ARCH_DEPTH = {"mistral_nemo_12b": 20, "starcoder2_15b": 20, "gemma3_27b": 30}


def phase_serve_engine_archs() -> None:
    """One ServeEngine per new arch at ENGINE_ARCH_DEPTH layers (published
    width), auto mode: the 16 requests of phase serve_engine, every bucket's
    step a CUDA graph, no plan-cache miss after warm (:func:`engine_run`);
    then graphs against eager at the first layers (:func:`twin_check`). The
    buckets' M is at most 8 x 64 = 512 rows, where auto mode plans every
    leaf on GEMM: no B̃ is held."""
    for arch in NEW_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=ENGINE_ARCH_DEPTH[arch])
        free_memory()
        params = M.init_params(cfg, 0, DEV)
        requests = engine_requests(cfg.vocab_size)
        graph = engine_run(f"{arch}/auto_fp", cfg, params, requests, True)
        twin_check(f"{arch}/auto_fp", cfg, params, requests)
        if graph["summary"]["precombined_weights"]:
            raise AssertionError(f"serve_engine/{arch}: {graph['summary']['precombined_weights']}"
                                 f" leaves planned at the buckets' M")
        del params, graph
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
    """Every leaf shape of the dense and the MoE archs that auto mode prices
    an fp LCMA to win at M = 2048 rows (h100_sxm, offline Combine B), bf16:
    torch.matmul, the "cuda" planned path (Group Combine A, then the fused
    GEMM + Combine H against B̃) and the "torch" planned path (the
    generated combines around one batched product, H in f32), each held to
    its plain version (the "fused" TOL) built from a plain B̃ and a plain
    Combine A: one rounding for "cuda", one per added term for "torch"
    (:func:`seq_combine_ref`, to which the generated Combine A is also
    held at the "combine" TOL), and timed
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
    for arch in ARCHS + MOE_ARCHS:
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
        # calls of 0.1-6 ms: 10 back-to-back launches a timed run
        ms = {name: time_ms(fn, launches=10) for name, fn in {**paths, **stages}.items()}
        d = falcon.plan(LEAF_M, K, N, fcfg, "bfloat16", precombined_b=True)
        du = falcon.plan(LEAF_M, K, N, tcfg, "bfloat16", precombined_b=True)
        est_u = next(e for e in du.estimates if e.lcma.name == scheme)
        bms, by = bound_ms(2.0 * LEAF_M * K * N, (LEAF_M * K + K * N + LEAF_M * N) * 2,
                           H100_SXM.flops_for("bfloat16"))
        X, Y, Z = cdiv(LEAF_M, l.m), cdiv(K, l.k), cdiv(N, l.n)
        emit("leaf_lcma", M=LEAF_M, K=K, N=N, scheme=scheme, users=users,
             predicted_speedup={"fused": d.speedup, "unfused": du.gemm_seconds / est_u.time},
             measured_speedup={p: ms["matmul"]["ms"] / ms[p]["ms"] for p in ("cuda", "torch")},
             # the paper's metric, 2MNK / t, measured and as the Decision
             # Module predicts it on the data sheet (h100_sxm)
             effective_tflops={p: effective_tflops(LEAF_M, N, K, ms[p]["ms"] / 1e3)
                               for p in paths},
             predicted_effective_tflops={
                 "matmul": predicted_effective_tflops(None, LEAF_M, N, K, H100_SXM),
                 "cuda": predicted_effective_tflops(l, LEAF_M, N, K, H100_SXM,
                                                    precombined_b=True),
                 "torch": predicted_effective_tflops(l, LEAF_M, N, K, H100_SXM,
                                                     precombined_b=True, fused=False)},
             ms={p: t["ms"] for p, t in ms.items()}, source={p: t["source"] for p, t in ms.items()},
             matmul_bound_ms=bms, matmul_bound_by=by, errors=errs, tol=TOL[bf]["fused"],
             fused_plan=fused_plan(tuning.plan_fused_tc(1, X, Y, Z, l.R, l.m, l.n)),
             timing=ms)
        del a, w, bt, at, at_t, h
        free_memory()


# ---------------------------------------------------------------------------
# The MoE family at full width: the grouped expert FFN (#2 and #4 over
# per-expert weights), one layer of dbrx_132b and of kimi_k2_1t, dbrx served
# one-shot and through the engine
# ---------------------------------------------------------------------------

MOE_ARCHS = ("dbrx_132b", "kimi_k2_1t")
MOE_SERVE = (4, 512)            # dbrx one-shot: a prefill of 2048 rows
MOE_GEN = 8
MOE_LAYER_T = 2048              # tokens of one moe_layer call (C = 768 dbrx, 54 kimi)
# |C - plain| / max|plain| of a whole planned path, as phase leaf_lcma holds it
LEAF_TOL = 0.01
# A bf16 MoE layer against its f32 plain version, or two bf16 runs of it
# against each other, normalized as TOL: eight bf16 unit roundoffs (2**-8
# each) of the largest output. A token's path rounds at g and u, silu(g),
# their product, the down projection and the gate-weighted term, then at
# each of its k running sums (4 dbrx, 8 kimi), where one kernel against its
# plain version rounds once (TOL).
LAYER_TOL = 8 * 2.0 ** -8


def moe_capacities(cfg) -> list[int]:
    """dbrx's capacities on the main paths: the one-shot prefill (4 x 512
    rows), its decode (4 rows) and every step of the engine's buckets."""
    rows = {MOE_SERVE[0] * MOE_SERVE[1], MOE_SERVE[0]} | {b * s for b, s in engine_steps(False)}
    return sorted({workloads.layer_capacity(cfg, T) for T in rows})


def moe_contexts() -> list[tuple[int, int, int, bool]]:
    """(batch, tokens per row, cache length, decode) of every call dbrx's
    main paths make: the one-shot's prefill (4 x 512) and decode steps
    against its 520-key cache, every prefill and decode bucket of the
    engine against the slot cache."""
    b, s = MOE_SERVE
    keys = engine_keys(False)
    pol = engine_policy(False)
    return ([(b, s, s + MOE_GEN, False), (b, 1, s + MOE_GEN, True)]
            + [(rows, n, keys, False) for rows, n in pol.prefill_shapes()]
            + [(rows, 1, keys, True) for rows in pol.decode_batch])


def check_grouped_fused(l: LCMA, G: int, X: int, Y: int, Z: int, gen,
                        chunk: int = 16) -> tuple[float, float, list]:
    """batched_fused_gemm_combine_h over G groups, each its own B̃ (the
    expert FFN's per-expert weights), bf16, filled one group at a time (the
    float32 draw of a whole stack would not fit beside it) and held to the
    plain version ``chunk`` groups at a time. Returns (max abs error, error
    as :func:`err`, output shape)."""
    bf = torch.bfloat16
    at = torch.empty(G, l.R, X, Y, dtype=bf, device=DEV)
    bt = torch.empty(G, l.R, Y, Z, dtype=bf, device=DEV)
    for g in range(G):
        at[g] = randn(l.R, X, Y, dtype=bf, gen=gen)
        bt[g] = randn(l.R, Y, Z, dtype=bf, gen=gen)
    got = kernels.batched_fused_gemm_combine_h(at, bt, l.W)
    torch.cuda.synchronize()
    d = scale = 0.0
    for g0 in range(0, G, chunk):
        want = ref.fused_gemm_combine_h_ref(at[g0:g0 + chunk], bt[g0:g0 + chunk], l.W)
        if got[g0:g0 + chunk].shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"batched_fused_gemm_combine_h/{l.name}: {got.shape} "
                                 f"{got.dtype} vs plain {want.shape} {want.dtype}")
        d = max(d, (got[g0:g0 + chunk].float() - want.float()).abs().max().item())
        scale = max(scale, want.float().abs().max().item())
        del want
    shape = list(got.shape)
    del at, bt, got
    free_memory()
    return d, d / max(1.0, scale), shape


def checked(make):
    """A check (gen -> (max abs error, error as :func:`err`, shape)) of the
    (kernel call, plain call) pair ``make(gen)`` returns."""
    def check(gen):
        kfn, pfn = make(gen)
        got = kfn()
        torch.cuda.synchronize()
        want = pfn()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{got.shape} {got.dtype} vs plain {want.shape} {want.dtype}")
        a, e = err(got, want)
        return a, e, list(got.shape)
    return check


def moe_kernel_cases() -> list[tuple[str, str, dict, object]]:
    """(kernel, scheme, shape fields, check) of every call the MoE archs'
    main paths make of #1-#4, bf16, each padded shape once.

    The expert FFN under forced strassen: Combine B of the whole expert
    stacks, Combine A of the activations (E, C, K) and the grouped fused
    product against per-expert B̃, for dbrx at each capacity of the main
    paths (C = 8, 160 and 768 among them), for kimi at phase moe_layer's
    C = 54 (G = 384). dbrx's other products at every call context
    (:func:`moe_contexts`, shapes from ``workloads.resolve_contractions``):
    under forced strassen Combine A and the fused product of each
    projection and of the LM head, the LM head's runtime Combine B, and
    both einsums of attention over b x 48 groups (#2, #4 per group); auto's
    planned leaves at the 2048-row prefill (s444 on w_q and w_o) through
    Combine A and the fused product. The offline Combine B of the served
    attention stacks is :func:`stacked_weight_cases`'. Each check returns
    (max abs error, error as :func:`err`, shape)."""
    l = alg.get("strassen")
    bf = torch.bfloat16
    out = []
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
        for K, N in ((d, ff), (ff, d)):
            out.append(("batched_group_combine", l.name, {"arch": arch, "stack": [E, K, N]},
                        functools.partial(check_stacked_combine, l, E, K, N)))
        caps = moe_capacities(cfg) if arch == "dbrx_132b" else [
            workloads.layer_capacity(cfg, MOE_LAYER_T)]
        for X in sorted({cdiv(C, l.m) for C in caps}):
            for K, N in ((d, ff), (ff, d)):
                out.append(("batched_group_combine", l.name,
                            {"arch": arch, "activations": [E, 2 * X, K]},
                            checked(functools.partial(combine_case, l, bf, (2 * X, K), "U",
                                                      groups=E))))
                out.append(("batched_fused_gemm_combine_h", l.name,
                            {"arch": arch, "per_group_bt": [E, l.R, K // 2, N // 2], "X": X},
                            functools.partial(check_grouped_fused, l, E, X, K // 2, N // 2)))
    cfg = get_config("dbrx_132b")
    g = lambda l, M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
    dense, attn = set(), set()
    for batch, seq, kv, decode in moe_contexts():
        for c in workloads.resolve_contractions(cfg, batch, seq, kv_len=kv, decode=decode):
            if c.kind == "dense":
                dense.add((c.role == "lm_head", c.m, c.k, c.n))
            elif c.kind == "attention":
                attn.add((c.group, c.m, c.k, c.n))
    planned = [(MOE_SERVE[0] * MOE_SERVE[1], K, N, dd.algo)
               for K, N, dd in planned_leaves(cfg, MOE_SERVE[0] * MOE_SERVE[1]).values()]
    products = [(l, M_, K, N) for _, M_, K, N in dense] + [(a, M_, K, N) for M_, K, N, a in planned]
    seen = set()
    for s, M_, K, N in sorted(products, key=lambda p: (p[0].name, p[1:])):
        X, Y, Z = g(s, M_, K, N)
        for name, key, make in (
                ("group_combine", (s.name, X, Y),
                 functools.partial(combine_case, s, bf, (X * s.m, Y * s.k), "U")),
                ("fused_gemm_combine_h", (s.name, X, Y, Z),
                 functools.partial(fused_case, s, bf, X, Y, Z))):
            if (name, key) not in seen:
                seen.add((name, key))
                out.append((name, s.name, {"arch": cfg.name, "product": [M_, K, N]},
                            checked(make)))
    for K, N in sorted({(K, N) for lm, _, K, N in dense if lm}):
        out.append(("group_combine", l.name, {"arch": cfg.name, "lm_head_b": [K, N]},
                    checked(functools.partial(combine_case, l, bf, (K, N), "V"))))
    for G, M_, K, N in sorted(attn):
        X, Y, Z = g(l, M_, K, N)
        for name, key, make in (
                ("batched_group_combine", ("U", G, X, Y),
                 functools.partial(combine_case, l, bf, (X * l.m, Y * l.k), "U", groups=G)),
                ("batched_group_combine", ("V", G, Y, Z),
                 functools.partial(combine_case, l, bf, (Y * l.k, Z * l.n), "V", groups=G)),
                ("batched_fused_gemm_combine_h", (G, X, Y, Z),
                 functools.partial(fused_case, l, bf, X, Y, Z, groups=G))):
            if (name, key) not in seen:
                seen.add((name, key))
                out.append((name, l.name, {"arch": cfg.name, "attention": [G, M_, K, N]},
                            checked(make)))
    return out


def moe_fit_depth(cfg, M_: int) -> tuple[int, dict]:
    """dbrx's depth on one card: the most layers whose bf16 weights, the
    most B̃ any of its runs keeps resident (auto's planned leaves at ``M_``
    rows, or forced strassen's four attention leaves) and the largest
    transient B̃ (one expert projection's per-expert Combine B, or the tied
    LM head's runtime Combine B, under forced strassen) fit in
    WEIGHT_BUDGET bytes. Returns (layers, the byte counts)."""
    it, l = 2, alg.get("strassen")
    attn = arch_leaves(cfg)
    E, d, ff, Vp = cfg.num_experts, cfg.d_model, cfg.d_ff, M.padded_vocab(cfg)
    raw = 2 * d * it + d * E * it + 3 * E * d * ff * it \
        + sum(K * N * it for K, N in attn.values())
    forced_bt = lambda K, N: l.R * cdiv(K, l.k) * cdiv(N, l.n) * it  # noqa: E731
    resident = max(sum(forced_bt(K, N) for K, N in attn.values()),
                   sum(dd.algo.R * cdiv(K, dd.algo.k) * cdiv(N, dd.algo.n) * it
                       for K, N, dd in planned_leaves(cfg, M_).values()))
    transient = max(E * forced_bt(d, ff), forced_bt(d, Vp))
    fixed = (Vp + 1) * d * it
    layers = min(cfg.num_layers, int((WEIGHT_BUDGET - fixed - transient) // (raw + resident)))
    if layers < 1:
        raise AssertionError(f"{cfg.name}: no layer fits in {WEIGHT_BUDGET} bytes")
    return layers, {"fixed": fixed, "per_layer_weights": raw, "per_layer_resident_bt": resident,
                    "transient_bt": transient, "budget": WEIGHT_BUDGET}


def moe_served() -> tuple[object, dict, dict | None]:
    """dbrx at its fitted depth (bf16, published widths): the config, the
    byte counts and the ``reduced`` field."""
    full = get_config("dbrx_132b")
    layers, sizes = moe_fit_depth(full, MOE_SERVE[0] * MOE_SERVE[1])
    reduced = {"num_layers": [full.num_layers, layers]} if layers < full.num_layers else None
    return dataclasses.replace(full, num_layers=layers), sizes, reduced


def expert_launches(state, cfg) -> dict[str, int]:
    """The launches of #2 and #4 in ``state`` (a :func:`kernels.launch_state`,
    counted by shape) that the expert FFN made under forced strassen: Combine
    B of the (E, d, d_ff) and (E, d_ff, d) stacks, Combine A of the (E, C, d)
    and (E, C, d_ff) activations and the grouped product against per-expert
    B̃, at every capacity C of the main paths (:func:`moe_capacities`)."""
    l = alg.get("strassen")
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    caps = [l.m * cdiv(C, l.m) for C in moe_capacities(cfg)]
    combine = {(E, d, ff), (E, ff, d)} | {(E, C, K) for C in caps for K in (d, ff)}
    fused = {((E, l.R, C // l.m, K // l.k), (E, l.R, K // l.k, N // l.n))
             for C in caps for K, N in ((d, ff), (ff, d))}
    return {"batched_group_combine": sum(
                n for key, n in state.items()
                if isinstance(key, tuple) and key[0] == "batched_group_combine"
                and key[1] in combine),
            "batched_fused_gemm_combine_h": sum(
                n for key, n in state.items()
                if isinstance(key, tuple) and key[0] == "batched_fused_gemm_combine_h"
                and key[1] in fused)}


def moe_layer_run(cfg, p, x, mode: str) -> dict:
    """``moe_apply`` on one full-width layer under ``mode`` (gemm or forced
    strassen), bf16: its output, the routes the router chose (recorded
    from ``_route``), each grouped projection's operands and product
    (recorded from ``engine.grouped_matmul``), the kernels' launches (and
    their ``launch_state``), the peak bytes, and the device time per call
    (:func:`time_ms`)."""
    from repro_torch.core import engine as core_engine
    C = workloads.layer_capacity(cfg, x.shape[0] * x.shape[1])
    seen = {"calls": []}
    route, grouped = MOE._route, core_engine.grouped_matmul

    def rec_route(*a):
        out = route(*a)
        seen["idx"] = out[2]
        return out

    def rec_grouped(a3, b, cfg_=None):
        y = grouped(a3, b, cfg_)
        seen["calls"].append((a3, b, y))
        return y

    fn = lambda: MOE.moe_apply(p, x, cfg.experts_per_token, cfg.capacity_factor,  # noqa: E731
                               deterministic_capacity=C)
    with falcon.use(falcon.FalconConfig(mode=mode)), torch.inference_mode():
        free_memory()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        MOE._route, core_engine.grouped_matmul = rec_route, rec_grouped
        try:
            y, _ = fn()
            torch.cuda.synchronize()
        finally:
            MOE._route, core_engine.grouped_matmul = route, grouped
        counts, state = kernels.launch_counts(), kernels.launch_state()
        peak = torch.cuda.max_memory_allocated() - base
        t = time_ms(fn, launches=3)
    return {"y": y, "idx": seen["idx"], "calls": seen["calls"], "C": C, "counts": counts,
            "state": state, "peak": peak, "time": t}


def phase_moe_layer() -> None:
    """One full-width MoE layer of dbrx (T = 2048 tokens, C = 768) and of
    kimi (T = 2048, C = 54), random bf16 weights and input from seed 0, in
    gemm mode and in forced strassen: device ms per call, launches of #2
    and #4, peak bytes. The router's routes must be bit-equal between the
    modes (a plain f32 product). Each layer is held to plain versions
    (``models.moe_ref``): the gemm run within LAYER_TOL of
    ``loop_moe_apply`` in f32 (a dispatch of its own: each expert's pairs
    found one expert at a time, at E = 384 for kimi), the forced run within
    LAYER_TOL of the gemm run and, for dbrx, within LEAF_TOL of the plain
    LCMA pipeline (the kernels' plain versions, each stage rounded as the
    kernels round it; kimi's would need a second 19.7 GB B̃ beside its 33.8
    GB of experts). Each forced projection's error against the GEMM of its
    own operands is printed beside strassen's static error bound, a reading
    only. Every launch must be at a shape phase_kernels checked."""
    from repro_torch.models.moe_ref import eager_moe_apply, lcma_expert_ffn, loop_moe_apply
    l = alg.get("strassen")
    bound = l.stability.error_bound("bfloat16")
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        free_memory()
        gen = torch.Generator(device=DEV).manual_seed(0)
        p = MOE.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, torch.bfloat16, DEV)
        x = randn(4, MOE_LAYER_T // 4, cfg.d_model, dtype=torch.bfloat16, gen=gen)
        runs = {mode: moe_layer_run(cfg, p, x, mode) for mode in ("gemm", "strassen")}
        gemm, forced = runs["gemm"], runs["strassen"]
        for mode, r in runs.items():
            check_covered(f"moe_layer/{arch}/{mode}", r["state"])
        same_routes = torch.equal(gemm["idx"], forced["idx"])
        # each forced projection against the GEMM of its own operands
        proj = []
        for a3, b, y in forced["calls"]:
            want = torch.matmul(a3, b)
            lim = bound * a3.float().abs().max().item() * b.float().abs().max().item() \
                * a3.shape[-1] + 2.0 ** -8 * want.float().abs().max().item()
            proj.append({"shape": [*a3.shape, b.shape[-1]],
                         "max_abs_err": (y.float() - want.float()).abs().max().item(),
                         "static_bound": lim})
            del want
        forced["calls"] = gemm["calls"] = None
        with torch.inference_mode():
            exact, idx, dropped = loop_moe_apply(p, x, cfg.experts_per_token, forced["C"])
        same_routes = same_routes and torch.equal(idx, gemm["idx"])
        layer = {"vs_gemm": err(forced["y"], gemm["y"]), "gemm_vs_exact": err(gemm["y"], exact),
                 "forced_vs_exact": err(forced["y"], exact)}
        tol = {"vs_gemm": LAYER_TOL, "gemm_vs_exact": LAYER_TOL}
        del exact
        if arch == "dbrx_132b":
            with torch.inference_mode():
                plain, _, _ = eager_moe_apply(p, x, cfg.experts_per_token, forced["C"],
                                              ffn=lcma_expert_ffn(l))
            layer["forced_vs_plain"] = err(forced["y"], plain)
            tol["forced_vs_plain"] = LEAF_TOL
            del plain
        for mode, r in runs.items():
            emit("moe_layer", arch=arch, mode=mode, tokens=MOE_LAYER_T, capacity=r["C"],
                 experts=cfg.num_experts, top_k=cfg.experts_per_token, d_model=cfg.d_model,
                 d_ff=cfg.d_ff, dropped_pairs=dropped, ms=r["time"]["ms"],
                 source=r["time"]["source"], timing=r["time"], launches=r["counts"],
                 peak_bytes=r["peak"])
        emit("moe_layer_check", arch=arch, routes_bit_equal=same_routes, projections=proj,
             layer_errors=layer, tol=tol, forced_speedup=gemm["time"]["ms"] / forced["time"]["ms"])
        if not same_routes:
            raise AssertionError(f"moe_layer/{arch}: the routes differ between the modes")
        if len(proj) != 3 or any(not layer[k][1] <= t for k, t in tol.items()):
            raise AssertionError(f"moe_layer/{arch}: layer errors {layer}, tolerances {tol}, "
                                 f"{len(proj)} forced projections")
        want = {"batched_group_combine": 6, "batched_fused_gemm_combine_h": 3}
        if {k: forced["counts"][k] for k in want} != want or sum(gemm["counts"].values()):
            raise AssertionError(f"moe_layer/{arch}: forced launched {forced['counts']}, "
                                 f"gemm {gemm['counts']}")
        del p, x, runs, gemm, forced
        free_memory()


@contextlib.contextmanager
def route_tape(replay: list | None = None):
    """Inside, every call of ``models.moe._route`` appends what it computed,
    (probs, gate values, expert_idx), to the yielded list; with ``replay``
    (another run's list, call for call) each call returns replay's entry
    instead, so the run dispatches on that run's routes and gate values."""
    route, tape = MOE._route, []

    def taped(*args):
        tape.append(route(*args))
        return tape[-1] if replay is None else replay[len(tape) - 1]

    MOE._route = taped
    try:
        yield tape
    finally:
        MOE._route = route


def kept_pairs(idx: np.ndarray, C: int, E: int) -> np.ndarray:
    """(T, E) bool: token t's pair routed to expert e was kept, its rank
    among e's pairs in token-major order below the capacity C."""
    flat = idx.reshape(-1)
    oh = flat[:, None] == np.arange(E)
    rank = (np.cumsum(oh, 0) - oh)[np.arange(flat.size), flat]
    kept = np.zeros((idx.shape[0], E), bool)
    kept[np.repeat(np.arange(idx.shape[0]), idx.shape[1]), flat] = rank < C
    return kept


def route_changes(tape: list, gemm_tape: list, cfg) -> list[dict]:
    """Per layer, summed over a teacher-forced run's calls (the prefill, then
    each decode step) against the gemm run's, call for call: the tokens
    whose set of experts changed, the (token, choice) pairs dropped for
    capacity in each run, and the (token, expert) pairs kept in one run
    and not in the other."""
    if len(tape) != len(gemm_tape):
        raise AssertionError(f"route_changes: {len(tape)} router calls vs {len(gemm_tape)}")
    out = [dict.fromkeys(("routes_changed", "dropped", "gemm_dropped", "kept_differ",
                          "pairs"), 0) for _ in range(cfg.num_layers)]
    for i, ((_, _, a), (_, _, b)) in enumerate(zip(tape, gemm_tape)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        C = workloads.layer_capacity(cfg, a.shape[0])
        ka, kb = kept_pairs(a, C, cfg.num_experts), kept_pairs(b, C, cfg.num_experts)
        o = out[i % cfg.num_layers]
        o["routes_changed"] += int((np.sort(a, 1) != np.sort(b, 1)).any(1).sum())
        o["dropped"] += int(a.size - ka.sum())
        o["gemm_dropped"] += int(b.size - kb.sum())
        o["kept_differ"] += int((ka != kb).sum())
        o["pairs"] += int(a.size)
    return out


def moe_teacher_forced(seed: int, base, params, gemm: dict, gate_own: bool) -> None:
    """dbrx's auto and forced runs teacher-forced on the gemm run's tokens
    (prompts from ``seed``), each twice: on their own routes, and on the
    gemm run's routes and gate values (:func:`route_tape`), so that the
    second error is the LCMA's rounding alone, with no route flipped by it.
    Emits per layer how many routes and capacity drops differ from gemm's;
    holds the error on gemm's routes within QUALITY_TOL and, with
    ``gate_own``, the error on the run's own routes too."""
    batch, prompt = MOE_SERVE
    tf = functools.partial(forced_logits, params=params, batch=batch, prompt=prompt,
                           tokens=gemm["tokens"], seed=seed)
    with route_tape() as gemm_tape:
        gemm_tf = tf(dataclasses.replace(base, falcon_mode="gemm"))
    for name, mode in (("auto", "auto"), ("forced", "strassen")):
        cfg = dataclasses.replace(base, falcon_mode=mode)
        free_memory()
        kernels.reset_launch_counts()
        with route_tape() as tape:
            own = forced_err(tf(cfg), gemm, base.vocab_size)
        check_covered(f"serve_moe/{name}/teacher-forced", kernels.launch_state())
        changes = route_changes(tape, gemm_tape, base)
        del tape
        free_memory()
        with route_tape(replay=gemm_tape):
            pinned = forced_err(tf(cfg), gemm, base.vocab_size)
        emit("serve_moe_routes", seed=seed, config=name, forced_rel_logit_err=own,
             pinned_routes_rel_logit_err=pinned, tol=QUALITY_TOL, own_routes_gated=gate_own,
             gemm_teacher_forced_vs_served=forced_err(gemm_tf, gemm, base.vocab_size),
             routes_changed=sum(c["routes_changed"] for c in changes),
             kept_differ=sum(c["kept_differ"] for c in changes),
             dropped=sum(c["dropped"] for c in changes),
             gemm_dropped=sum(c["gemm_dropped"] for c in changes), per_layer=changes)
        if not (pinned <= QUALITY_TOL and (own <= QUALITY_TOL or not gate_own)):
            raise AssertionError(f"serve_moe/seed {seed}/{name}: teacher-forced logit error "
                                 f"against gemm {own}, on gemm's routes {pinned} "
                                 f"(tolerance {QUALITY_TOL})")
    del gemm_tape, gemm_tf
    free_memory()


def phase_serve_moe() -> dict:
    """dbrx at published width, depth cut to what fits (:func:`moe_fit_depth`),
    bf16, random weights from seed 0, served one-shot (4 x 512 prompt
    tokens, 8 new) three ways, each after a 2-token warm-up serve: ``gemm``
    (every product on torch.matmul, the reference), ``auto`` (h100_sxm: the
    leaves it prices to an LCMA at M = 2048 precombined, s444 on w_q and
    w_o; the experts' runtime path on GEMM) and ``forced``
    (strassen everywhere: the experts through Combine A and B (#2) and the
    grouped fused GEMM against per-expert B̃ (#4) at every call). Each
    non-gemm run is held to gemm within QUALITY_TOL, prefix-matched, and
    teacher-forced on its own routes and on gemm's (:func:`moe_teacher_forced`,
    with the routes that differ counted per layer); the forced run's expert
    launches must be exactly 2 x #2 and 1 x #4 per projection, layer and
    step, auto's none, and every launch at a shape phase_kernels checked.
    gemm and forced are then profiled over prefill and one decode step
    (``profile_moe``). Then the weights and prompts drawn from seed 1: gemm
    served, auto and forced teacher-forced on it, held within QUALITY_TOL
    on gemm's routes; on their own routes the error is a reading (at seed
    1 forced strassen's flipped routes take it past 0.15). Returns the
    forced run's launch counts."""
    base, sizes, reduced = moe_served()
    batch, prompt = MOE_SERVE
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = M.init_params(base, 0, DEV)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    emit("serve_moe_weights", arch=base.name, layers=base.num_layers, reduced=reduced,
         weight_bytes=held, init_transient_bytes=torch.cuda.max_memory_allocated() - before - held,
         predicted=sizes,
         planned={path: describe(d) for path, (_, _, d)
                  in planned_leaves(base, batch * prompt).items()})
    Lc = base.num_layers
    runs, counts = {}, {}
    for name, mode in (("gemm", "gemm"), ("auto", "auto"), ("forced", "strassen")):
        cfg = dataclasses.replace(base, falcon_mode=mode)
        planned = {path: describe(d) for path, (_, _, d)
                   in planned_leaves(cfg, batch * prompt).items()}
        run_oneshot(cfg, batch=batch, prompt_len=prompt, gen=2, seed=0, device=DEV,
                    params=params)
        free_memory()
        res, counts[name] = serve("serve_moe", cfg, params, batch=batch, prompt=prompt,
                                  gen=MOE_GEN, config=name, planned=planned, reduced=reduced)
        state = kernels.launch_state()
        check_covered(f"serve_moe/{name}", state)
        experts = expert_launches(state, base)
        runs[name] = res
        want = {"batched_group_combine": 6 * Lc * MOE_GEN,
                "batched_fused_gemm_combine_h": 3 * Lc * MOE_GEN} if name == "forced" else \
            dict.fromkeys(experts, 0)
        emit("serve_moe_experts", config=name, expert_launches=experts, expected=want)
        if experts != want:
            raise AssertionError(f"serve_moe/{name}: expert-path launches {experts}, "
                                 f"expected {want}")
        if res["n_precombined"] != len(planned):
            raise AssertionError(f"serve_moe/{name}: {res['n_precombined']} leaves "
                                 f"precombined, the pricing names {planned}")
        if name != "gemm":
            err_ = quality(f"serve_moe/{name}", per_request(res), per_request(runs["gemm"]),
                           base.vocab_size)
            emit("serve_moe_vs_gemm", config=name, rel_logit_err=err_, tol=QUALITY_TOL,
                 prefill_ms=res["timings"]["prefill_ms"],
                 gemm_prefill_ms=runs["gemm"]["timings"]["prefill_ms"],
                 prefill_speedup=runs["gemm"]["timings"]["prefill_ms"]
                 / res["timings"]["prefill_ms"],
                 decode_ms_per_step=res["timings"]["decode_ms_per_step"],
                 gemm_decode_ms_per_step=runs["gemm"]["timings"]["decode_ms_per_step"],
                 reduced=reduced)
        if name != "auto":
            # where the time goes: prefill and one decode step under the
            # profiler, on weights precombined beforehand
            with falcon.use(M.falcon_config_for(cfg)), torch.inference_mode():
                planned_params, _ = falcon.precombine_params(params, m_hint=batch * prompt)
            _, prof = profiled(functools.partial(
                run_oneshot, cfg, batch=batch, prompt_len=prompt, gen=2, seed=0, device=DEV,
                params=planned_params, precombine=False))
            emit("profile_moe", config=name, window="prefill + 1 decode step (profiler on)",
                 **prof)
            del planned_params
        free_memory()
    moe_teacher_forced(0, base, params, runs["gemm"], gate_own=True)
    del params, runs
    free_memory()
    params = M.init_params(base, 1, DEV)
    gemm, _ = serve("serve_moe", dataclasses.replace(base, falcon_mode="gemm"), params,
                    batch=batch, prompt=prompt, gen=MOE_GEN, seed=1, config="gemm",
                    weights_seed=1, reduced=reduced)
    moe_teacher_forced(1, base, params, gemm, gate_own=False)
    del params, gemm
    free_memory()
    return counts["forced"]


def phase_serve_engine_moe() -> None:
    """The continuous-batching ServeEngine on dbrx at the depth that fits
    (published width, bf16, seed 0), the 16 requests of phase serve_engine
    over 8 slots: auto mode (every product on GEMM at the buckets' M <=
    512) and forced strassen (the experts' Combine B at every step, inside
    each step's graph), each with every bucket's step a CUDA graph and
    eagerly: identical tokens, logits within the bf16 TOL, equal launch
    counts, no plan-cache miss after warm (:func:`engine_run`), every launch
    at a shape phase_kernels checked. Forced against auto, prefix-matched,
    is reported (:func:`logit_error`): a
    route flipped by the LCMA's rounding changes which tokens a bucket's
    capacity drops, so it is read, not gated."""
    base, _, reduced = moe_served()
    free_memory()
    params = M.init_params(base, 0, DEV)
    requests = engine_requests(base.vocab_size)
    graphs = {}
    for name, mode in (("auto", "auto"), ("forced", "strassen")):
        cfg = dataclasses.replace(base, falcon_mode=mode)
        runs = {g: engine_run(f"dbrx_132b/{name}", cfg, params, requests, g, profile=g)
                for g in (True, False)}
        graph, eager = runs[True], runs[False]
        check_covered(f"serve_engine/dbrx_132b/{name}", eager["state"])
        same = all(g[0] == e[0] for g, e in zip(graph["outputs"], eager["outputs"]))
        diff = max(err(torch.as_tensor(np.stack(g[1])), torch.as_tensor(np.stack(e[1])))[1]
                   for g, e in zip(graph["outputs"], eager["outputs"]))
        experts = expert_launches(graph["state"], base)
        emit("serve_engine_check", config=f"dbrx_132b/{name}", identical_tokens=same,
             max_logit_err=diff, tol=TOL[torch.bfloat16]["fused"],
             launches_equal=graph["state"] == eager["state"], reduced=reduced,
             layers=base.num_layers, expert_launches=experts,
             n_precombined=graph["summary"]["precombined_weights"],
             decode_speedup=eager["summary"]["t_decode"] / graph["summary"]["t_decode"])
        if not same or not diff <= TOL[torch.bfloat16]["fused"] \
                or graph["state"] != eager["state"]:
            raise AssertionError(f"serve_engine/dbrx_132b/{name}: graphs and eager differ "
                                 f"(identical tokens {same}, logit error {diff}, launches "
                                 f"{dict(graph['state'])} vs {dict(eager['state'])})")
        if (name == "forced") != (min(experts.values()) > 0) or \
                (name == "auto") != (max(experts.values()) == 0):
            raise AssertionError(f"serve_engine/dbrx_132b/{name}: expert-path launches "
                                 f"{experts}")
        graphs[name] = graph["outputs"]
        del runs, graph, eager
        free_memory()
    worst, compared, agreement = logit_error(graphs["forced"], graphs["auto"], base.vocab_size)
    emit("serve_engine_moe_vs_auto", rel_logit_err=worst, steps_compared=compared,
         token_agreement=agreement)
    del params, graphs
    free_memory()


# ---------------------------------------------------------------------------
# The SSM and hybrid families at published width and depth: the SSD mixer
# alone, one-shot serving, the engine
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_370m", "hymba_1_5b")
# The depth the SSM phases serve at: half the published depth (48 and 32
# layers), at published width, to make room in the run's time for phase
# serve_mesh (what the comparisons hold does not depend on depth; the SSD
# mixer's phase runs one full-width mixer either way)
SSM_DEPTH = {"mamba2_370m": 24, "hymba_1_5b": 16}
SSM_SERVE = (4, 2048)           # one-shot: 4 x 2048 prompt tokens, 8 chunks of 256
SSM_GEN = 16
SSD_ROLES = ("ssd.scores", "ssd.y_diag", "ssd.states", "ssd.y_off")
# The dtype in which the SSM phases hold two served runs to one another
# within QUALITY_TOL. Both stacks, at the reference's random init and
# published depth, amplify a rounding difference from layer to layer, so
# two bf16 runs that round differently (gemm and strassen, bucketed and one
# request at a time, chunked and whole) can disagree past QUALITY_TOL while
# each is right: mamba2's gemm run on bf16 weights disagrees with the gemm
# run on the same weights in float32 by about 1, hymba's forced strassen
# bf16 run with gemm by about the limit (phase serve_ssm prints both,
# ``serve_ssm_sensitivity`` and ``serve_ssm_vs_gemm``). In float32 the
# same amplification leaves such runs well within it, so each comparison
# is held in float32 and printed in bf16.
SSM_HELD = "float32"


# models.layers.flash_attention's query chunk: a prefill of more queries
# runs its attention 512 queries at a time
FLASH_Q = 512


def ssm_served(arch: str):
    """The config the SSM phases serve ``arch`` at: published width, SSM_DEPTH layers."""
    return dataclasses.replace(get_config(arch), num_layers=SSM_DEPTH[arch])


def as_dtype(tree, dtype: str):
    """The parameter tree with every leaf in ``dtype`` (a copy)."""
    return {k: as_dtype(v, dtype) if isinstance(v, dict) else v.to(getattr(torch, dtype))
            for k, v in tree.items()}


def ssm_contexts() -> list[tuple[int, int, int, bool, int]]:
    """(batch, tokens per row, cache length, decode, m_hint) of every call
    the SSM phases make: the one-shot's prefill (4 x 2048; phase
    ssd_layer's mixer takes the same shapes) and decode steps against its
    2064-key cache (2050 keys: the warm-up and profiled serves, 2 new
    tokens), and every prefill and decode bucket of the engine, with and
    without 16-token prefill chunks, against the slot cache. ``m_hint`` is
    the rows each run prices its offline Combine B at."""
    b, s = SSM_SERVE
    out = {(b, n, s + gen, n == 1, b * s) for n in (s, 1) for gen in (SSM_GEN, 2)}
    keys = engine_keys(False)
    for chunked in (False, True):
        pol = engine_policy(chunked)
        hint = pol.prefill_batch[-1] * pol.prefill_seq[-1]
        out |= {(rows, n, keys, False, hint) for rows, n in pol.prefill_shapes()}
        out |= {(rows, 1, keys, True, hint) for rows in pol.decode_batch}
    return sorted(out)


def planned_launches(cfg, mode: str, contexts, quantize: bool = False,
                     mesh_shape: dict | None = None) -> set[tuple]:
    """Every product of ``cfg`` at the call ``contexts`` ((batch, tokens per
    row, cache length, decode, m_hint) each) that runs an LCMA under
    ``mode`` ("auto" on h100_sxm, or a forced scheme), decided as
    ``core.engine`` dispatches it: a grouped contraction (attention, over
    512-query chunks past 512 queries; the SSD scan and decode step) by
    plan_batched in the dtype it runs in (the SSD ones float32); the tied LM
    head by plan, its Combine B at every call; a static leaf (an untied
    audio head: one per codebook, its stack CB deep) planned at its run's
    m_hint, then re-decided at the call's rows restricted to its scheme,
    under ``quantize`` on the int8 pipeline where its decision quantizes
    (a forced scheme: always), its B̃q combined offline one slice at a
    time. Keys: ("grouped", scheme, dtype, G, M, K, N), ("dense", scheme,
    dtype, M, K, N, runtime Combine B), ("stack", scheme, dtype, layers, K,
    N) (a leaf's offline Combine B), ("quant", scheme, dtype, M, K, N) (#6
    and #7) and ("offline_b", scheme, dtype, K, N) (a slice's Combine B on
    the way to its B̃q). ``mesh_shape``: the shapes one rank of that mesh
    contracts (``resolve_contractions(..., local=True)``)."""
    fcfg = falcon.FalconConfig(mode=mode, quantize=quantize)
    audio = cfg.frontend == "audio_codebooks"
    out = set()
    for batch, seq, kv, decode, hint in contexts:
        calls = [(c, cfg.num_layers) for c in workloads.resolve_contractions(
            cfg, batch, seq, kv_len=kv, decode=decode, mesh_shape=mesh_shape,
            local=bool(mesh_shape)) if not (audio and c.role == "lm_head")]
        if audio:       # one (d, Vp) head per codebook, on each row's last position
            calls.append((workloads.Contraction("dense", "lm_head", batch, cfg.d_model,
                                                M.padded_vocab(cfg)), cfg.num_codebooks))
        for c, layers in calls:
            dtype = "float32" if c.kind in workloads.F32_KINDS else cfg.dtype
            if c.group > 1:
                m = c.m
                if c.kind == "attention" and not decode and c.m > FLASH_Q:
                    m = FLASH_Q
                d = falcon.plan_batched(c.group, m, c.k, c.n, fcfg, dtype, shared_b=c.shared_b)
                if d.use_lcma:
                    out.add(("grouped", d.algo.name, dtype, c.group, m, c.k, c.n))
            elif c.role == "lm_head" and cfg.tie_embeddings:
                d = falcon.plan(c.m, c.k, c.n, fcfg, dtype)
                if d.use_lcma:
                    out.add(("dense", d.algo.name, dtype, c.m, c.k, c.n, True))
            else:
                d = falcon.plan(hint, c.k, c.n, fcfg, dtype, precombined_b=True)
                if not d.use_lcma:
                    continue
                out.add(("stack", d.algo.name, dtype, layers, c.k, c.n))
                if quantize:
                    out.add(("offline_b", d.algo.name, dtype, c.k, c.n))
                int8 = quantize
                if mode != d.algo.name:
                    dd = falcon.plan(c.m, c.k, c.n, dataclasses.replace(
                        fcfg, mode="auto", candidates=(d.algo.name,)), dtype,
                        precombined_b=True)
                    if not dd.use_lcma:
                        continue
                    int8 = quantize and dd.quantized
                out.add(("quant", d.algo.name, dtype, c.m, c.k, c.n) if int8 else
                        ("dense", d.algo.name, dtype, c.m, c.k, c.n, False))
    return out


def ssm_launches(cfg, mode: str) -> set[tuple]:
    """:func:`planned_launches` at the SSM phases' contexts
    (:func:`ssm_contexts`); forced, also phase ssd_layer's raw projections
    with their Combine B."""
    out = planned_launches(cfg, mode, ssm_contexts())
    if mode != "auto" and cfg.dtype == "bfloat16":
        # phase ssd_layer's mixer holds its projections raw: Combine B at each call
        for c in workloads.contraction_set(cfg):
            if c.role.startswith("ssm."):
                out.add(("dense", mode, cfg.dtype, math.prod(SSM_SERVE), c.k, c.n, True))
    return out


def launch_kernel_cases(arch_keys: dict[str, set]) -> list[tuple]:
    """(kernel, scheme, dtype, shape fields, check) of every call of #1-#4
    that the keys of :func:`planned_launches` (per arch) name, each padded
    shape and dtype once: Combine A and B (#2) and the grouped product (#4)
    of a grouped contraction, Combine A (#1) and the fused product (#3) of
    a planned product, a runtime Combine B (#1), a leaf's offline Combine B
    over its stack (#2) and, on the way to a B̃q, one slice's (#1). The
    int8 kernels' keys are phase_quant_kernels'. Each check returns (max
    abs error, error as :func:`err`, shape)."""
    out, seen = [], set()

    def add(name, key, l, dt, fields, check):
        if (name, key) not in seen:
            seen.add((name, key))
            out.append((name, l.name, dt, fields, check))

    for arch, keys in arch_keys.items():
        for key in sorted(keys, key=str):
            kind, scheme = key[:2]
            l = alg.get(scheme)
            fields = {"arch": arch, kind: list(key[2:])}
            dt = getattr(torch, key[2])
            if kind == "quant":
                continue
            if kind == "stack":
                G, K, N = key[3:]
                add("batched_group_combine", key, l, dt, fields,
                    functools.partial(check_stacked_combine, l, G, K, N, dtype=dt))
                continue
            if kind == "offline_b":
                K, N = key[3:]
                add("group_combine", (scheme, key[2], "V", cdiv(K, l.k), cdiv(N, l.n)), l, dt,
                    fields, checked(functools.partial(combine_case, l, dt, (K, N), "V")))
                continue
            if kind == "grouped":
                G, M_, K, N = key[3:]
                X, Y, Z = cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n)
                for name, sub, make in (
                        ("batched_group_combine", ("U", G, X, Y),
                         functools.partial(combine_case, l, dt, (M_, K), "U", groups=G)),
                        ("batched_group_combine", ("V", G, Y, Z),
                         functools.partial(combine_case, l, dt, (K, N), "V", groups=G)),
                        ("batched_fused_gemm_combine_h", (G, X, Y, Z),
                         functools.partial(fused_case, l, dt, X, Y, Z, groups=G))):
                    add(name, (scheme, key[2], *sub), l, dt, fields, checked(make))
                continue
            M_, K, N, runtime_b = key[3:]
            X, Y, Z = cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n)
            add("group_combine", (scheme, key[2], "U", X, Y), l, dt, fields,
                checked(functools.partial(combine_case, l, dt, (M_, K), "U")))
            if runtime_b:
                add("group_combine", (scheme, key[2], "V", Y, Z), l, dt, fields,
                    checked(functools.partial(combine_case, l, dt, (K, N), "V")))
            add("fused_gemm_combine_h", (scheme, key[2], X, Y, Z), l, dt, fields,
                checked(functools.partial(fused_case, l, dt, X, Y, Z)))
    return out


def ssm_kernel_cases() -> list[tuple[str, str, torch.dtype, dict, object]]:
    """:func:`launch_kernel_cases` of every call of #1-#4 the SSM phases
    make, auto mode and forced strassen, both archs in bf16 and in SSM_HELD
    (:func:`ssm_launches`; SSM_HELD at the first layers): the SSD contractions' Combine A and B (#2) and
    grouped product (#4) in float32 at the served groups (B x n_chunks x H
    at a prefill, B x H at a decode step, the state update's K = 1 padded
    to 2), hymba's attention, Combine A (#1) and the fused product (#3) of
    each planned projection, the tied LM head's Combine B at every call,
    and each planned leaf's offline Combine B over its layer stack."""
    arch_keys = {}
    for arch in SSM_ARCHS:
        keys = set()
        for dtype in ("bfloat16", SSM_HELD):
            cfg = dataclasses.replace(ssm_served(arch), dtype=dtype)
            if dtype == SSM_HELD:       # served at the first layers
                cfg = dataclasses.replace(cfg, num_layers=twin_depth(cfg))
            keys |= ssm_launches(cfg, "auto") | ssm_launches(cfg, "strassen")
        arch_keys[arch] = keys
    return launch_kernel_cases(arch_keys)


def ssd_decisions(cfg) -> dict[str, str]:
    """What auto mode decides on h100_sxm for each SSD contraction of
    ``cfg`` (float32, as they run) at the one-shot's prefill and decode
    and at the engine's largest prefill and decode buckets."""
    fcfg = falcon.FalconConfig()
    out = {}
    b, s = SSM_SERVE
    pol = engine_policy(False)
    for batch, seq, decode in ((b, s, False), (b, 1, True),
                               (*pol.prefill_shapes()[-1], False), (pol.decode_batch[-1], 1, True)):
        for c in workloads.resolve_contractions(cfg, batch, seq, kv_len=s + SSM_GEN,
                                                decode=decode):
            if c.kind in workloads.F32_KINDS:
                d = falcon.plan_batched(c.group, c.m, c.k, c.n, fcfg, "float32")
                out[f"{batch}x{seq} {c.role} {c.key_shape()}"] = describe(d)
    return out


def phase_ssd_layer() -> None:
    """One full-width SSD mixer of each arch (random bf16 weights and input
    from seed 0; 4 x 2048 tokens, 8 chunks of 256) in gemm mode and in
    forced strassen: device ms per call, launches, peak bytes. The gemm
    run's output and final state are held within LAYER_TOL of the plain
    float32 scan (``models.ssd_ref.plain_ssd_apply``: every operand taken
    to float32, ``torch.einsum``), the forced run's within LAYER_TOL of the
    gemm run's. Then the four scan contractions on the operands the gemm
    run gave them, each timed (CUDA events) through ``engine.einsum`` in
    gemm mode (``torch.matmul`` of the grouped operands, float32 with TF32
    off, with the permutes) and in forced strassen (Combine A and B on #2,
    the product on #4, with the permutes), beside each one's bound and the
    chunk loop (``ssd.carry_states``, one ``addcmul`` per chunk); and what
    auto mode decides for every SSD contraction on h100_sxm. Every launch
    is at a shape phase_kernels checked."""
    from repro_torch.core import engine as core_engine
    from repro_torch.models import ssd as SSD
    from repro_torch.models.ssd_ref import plain_ssd_apply
    b, s = SSM_SERVE
    fa = H100_SXM.flops_for("float32")
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        free_memory()
        gen = torch.Generator(device=DEV).manual_seed(0)
        p = SSD.ssd_init(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_groups, torch.bfloat16, DEV)
        x = randn(b, s, cfg.d_model, dtype=torch.bfloat16, gen=gen)
        fn = lambda: SSD.ssd_apply(p, x, cfg)  # noqa: E731
        runs = {}
        for mode in ("gemm", "strassen"):
            with falcon.use(falcon.FalconConfig(mode=mode)), torch.inference_mode():
                free_memory()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                y, st = fn()
                torch.cuda.synchronize()
                counts, state = kernels.launch_counts(), kernels.launch_state()
                peak = torch.cuda.max_memory_allocated() - base
                t = time_ms(fn, launches=3)
            check_covered(f"ssd_layer/{arch}/{mode}", state)
            runs[mode] = {"y": y, "state": st, "counts": counts, "peak": peak, "time": t}
        gemm, forced = runs["gemm"], runs["strassen"]
        with torch.inference_mode():
            y_ref, s_ref = plain_ssd_apply(p, x, cfg)
        errors = {"gemm_vs_plain": err(gemm["y"], y_ref),
                  "forced_vs_gemm": err(forced["y"], gemm["y"]),
                  "state_gemm_vs_plain": err(gemm["state"], s_ref),
                  "state_forced_vs_gemm": err(forced["state"], gemm["state"])}
        del y_ref, s_ref
        for mode, r in runs.items():
            emit("ssd_layer", arch=arch, mode=mode, tokens=b * s, chunk=cfg.ssm_chunk,
                 heads=cfg.ssm_heads, groups=cfg.ssm_groups, state=cfg.ssm_state,
                 ms=r["time"]["ms"], source=r["time"]["source"], timing=r["time"],
                 launches=r["counts"], peak_bytes=r["peak"])
        emit("ssd_layer_check", arch=arch, errors=errors, tol=LAYER_TOL,
             forced_speedup=gemm["time"]["ms"] / forced["time"]["ms"])
        if any(not e[1] <= LAYER_TOL for e in errors.values()):
            raise AssertionError(f"ssd_layer/{arch}: errors {errors} past {LAYER_TOL}")
        want = {"batched_group_combine": 8, "batched_fused_gemm_combine_h": 4}
        if {k: forced["counts"][k] for k in want} != want or sum(gemm["counts"].values()):
            raise AssertionError(f"ssd_layer/{arch}: forced launched {forced['counts']}, "
                                 f"gemm {gemm['counts']}")
        del runs, gemm, forced
        # the scan's four contractions and its chunk loop, on the operands
        # of one gemm-mode call
        calls, carried = [], []
        einsum, carry = core_engine.einsum, SSD.carry_states

        def rec_einsum(sub, *ops, cfg=None):
            calls.append((sub, ops))
            return einsum(sub, *ops, cfg=cfg)

        def rec_carry(*a):
            carried.append(a)
            return carry(*a)

        with falcon.use(falcon.FalconConfig(mode="gemm")), torch.inference_mode():
            core_engine.einsum, SSD.carry_states = rec_einsum, rec_carry
            try:
                fn()
            finally:
                core_engine.einsum, SSD.carry_states = einsum, carry
        if len(calls) != len(SSD_ROLES) or len(carried) != 1:
            raise AssertionError(f"ssd_layer/{arch}: {len(calls)} contractions, "
                                 f"{len(carried)} chunk loops")
        rows = {}
        for role, (sub, (a, bb)) in zip(SSD_ROLES, calls):
            c = next(c for c in workloads.resolve_contractions(cfg, b, s) if c.role == role)
            line = {"subscripts": sub, "groups": c.group, "mkn": [c.m, c.k, c.n],
                    "gflop": 2.0 * c.group * c.m * c.k * c.n / 1e9}
            line["bound_ms"], line["bound_by"] = bound_ms(
                2.0 * c.group * c.m * c.k * c.n,
                4.0 * c.group * (c.m * c.k + c.k * c.n + c.m * c.n), fa)
            for mode in ("gemm", "strassen"):
                with falcon.use(falcon.FalconConfig(mode=mode)), torch.inference_mode():
                    t = time_ms(lambda: einsum(sub, a, bb), launches=10)
                line[f"{mode}_ms"], line[f"{mode}_source"] = t["ms"], t["source"]
            rows[role] = line
        with torch.inference_mode():
            t = time_ms(lambda: carry(*carried[0]), launches=10)
        total = {mode: sum(r[f"{mode}_ms"] for r in rows.values()) for mode in ("gemm", "strassen")}
        emit("ssd_contractions", arch=arch, contractions=rows, chunk_loop_ms=t["ms"],
             chunk_loop_source=t["source"], chunks=cdiv(s, cfg.ssm_chunk),
             scan_gemm_ms=total["gemm"], scan_strassen_ms=total["strassen"],
             scan_bound_ms=sum(r["bound_ms"] for r in rows.values()))
        emit("ssd_decisions", arch=arch, hardware=falcon.FalconConfig().hardware,
             decisions=ssd_decisions(cfg))
        del calls, carried, p, x
        free_memory()


def phase_serve_ssm() -> dict:
    """Each SSM and hybrid arch at published width and SSM_DEPTH layers,
    random weights from seed 0, served one-shot (4 x 2048 prompt tokens, 16 new)
    three ways, each after a 2-token warm-up serve: ``gemm`` (every product
    on torch.matmul, the reference), ``auto`` (h100_sxm: the leaves it
    prices to an LCMA at M = 8192 precombined; the f32 SSD contractions
    priced at their groups) and ``forced`` (strassen everywhere: the
    projections on #1/#3, the SSD contractions and hymba's attention on
    #2/#4). First in bf16, the published dtype, with the times: each
    non-gemm run compared with gemm, prefix-matched and teacher-forced on
    gemm's tokens (printed: SSM_HELD); the forced run must have launched
    each of #1-#4; gemm and forced profiled over prefill and one decode
    step (``profile_ssm``). ``serve_ssm_sensitivity``: gemm on the same
    weights in float32, teacher-forced on the bf16 gemm run's tokens,
    against it: what bf16 rounding alone moves the logits by. Then the
    three again on the weights in SSM_HELD (float32), at the first layers
    (:func:`twin_depth`), auto and forced held to gemm within QUALITY_TOL,
    prefix-matched and teacher-forced. Every
    launch is at a shape phase_kernels checked. Returns the bf16 forced
    mamba2 run's launches of #1-#4 at prefill and decode (#2 and #4's are
    all SSD contractions)."""
    b, s = SSM_SERVE
    ssd_counts = {}
    modes = (("gemm", "gemm"), ("auto", "auto"), ("forced", "strassen"))
    for arch in SSM_ARCHS:
        base = ssm_served(arch)
        vocab = base.vocab_size
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        params = M.init_params(base, 0, DEV)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        emit("serve_ssm_weights", arch=arch, layers=base.num_layers, weight_bytes=held,
             init_transient_bytes=torch.cuda.max_memory_allocated() - before - held)
        runs = {}
        for name, mode in modes:
            cfg = dataclasses.replace(base, falcon_mode=mode)
            res = ssm_serve(arch, name, cfg, params)
            runs[name] = res
            if name == "forced":
                path = {k: res["launches"]["prefill"][k] + res["launches"]["decode"][k]
                        for k in ENGINE_FP_KERNELS}
                if min(path.values()) <= 0:
                    raise AssertionError(f"serve_ssm/{arch}/forced: a kernel of the path "
                                         f"never launched: {path}")
                if arch == "mamba2_370m":
                    ssd_counts = path
            if name != "gemm":
                ssm_vs_gemm(arch, name, cfg, params, res, runs["gemm"], gated=False)
            if name != "auto":
                kernels.reset_launch_counts()
                with falcon.use(M.falcon_config_for(cfg)), torch.inference_mode():
                    planned_params, _ = falcon.precombine_params(params, m_hint=b * s)
                _, prof = profiled(functools.partial(
                    run_oneshot, cfg, batch=b, prompt_len=s, gen=2, seed=0, device=DEV,
                    params=planned_params, precombine=False))
                check_covered(f"serve_ssm/{arch}/{name}/profile", kernels.launch_state())
                emit("profile_ssm", arch=arch, config=name,
                     window="prefill + 1 decode step (profiler on)", **prof)
                del planned_params
            free_memory()
        held_params = as_dtype(params, SSM_HELD)
        gemm_held = dataclasses.replace(base, dtype=SSM_HELD, falcon_mode="gemm")
        sens = forced_err(forced_logits(gemm_held, held_params, b, s, runs["gemm"]["tokens"]),
                          runs["gemm"], vocab)
        emit("serve_ssm_sensitivity", arch=arch, bf16_vs_f32_rel_logit_err=sens,
             tol=QUALITY_TOL)
        del params, runs
        # the held runs at the first layers
        gemm_held, held_params = cut_depth(gemm_held, held_params, twin_depth(gemm_held))
        free_memory()
        runs = {}
        for name, mode in modes:
            cfg = dataclasses.replace(gemm_held, falcon_mode=mode)
            runs[name] = ssm_serve(arch, f"{name}_{SSM_HELD}", cfg, held_params)
            if name != "gemm":
                ssm_vs_gemm(arch, f"{name}_{SSM_HELD}", cfg, held_params, runs[name],
                            runs["gemm"], gated=True)
            free_memory()
        del held_params, runs
        free_memory()
    return ssd_counts


def ssm_serve(arch: str, name: str, cfg, params) -> dict:
    """One measured one-shot serve of phase serve_ssm (4 x 2048 tokens, 16
    new) after a 2-token warm-up serve, each launch at a checked shape;
    a gemm run launches no kernel. Returns :func:`serve`'s result."""
    b, s = SSM_SERVE
    planned = {path: describe(d) for path, (_, _, d) in planned_leaves(cfg, b * s).items()}
    kernels.reset_launch_counts()
    run_oneshot(cfg, batch=b, prompt_len=s, gen=2, seed=0, device=DEV, params=params)
    check_covered(f"serve_ssm/{arch}/{name}/warm-up", kernels.launch_state())
    free_memory()
    res, counts = serve("serve_ssm", cfg, params, batch=b, prompt=s, gen=SSM_GEN,
                        config=name, planned=planned)
    check_covered(f"serve_ssm/{arch}/{name}", kernels.launch_state())
    if cfg.falcon_mode == "gemm" and (res["n_precombined"] or sum(counts.values())):
        raise AssertionError(f"serve_ssm/{arch}/{name}: precombined {res['n_precombined']}, "
                             f"launches {counts}")
    if cfg.falcon_mode != "gemm" and res["n_precombined"] != len(planned):
        raise AssertionError(f"serve_ssm/{arch}/{name}: {res['n_precombined']} leaves "
                             f"precombined, the pricing names {planned}")
    return res


def ssm_vs_gemm(arch: str, name: str, cfg, params, res: dict, gemm: dict, gated: bool):
    """A serve_ssm run against the gemm run of its dtype: the prefix-matched
    logit error (:func:`logit_error`) and the teacher-forced one on gemm's
    tokens (:func:`forced_logits`), each held within QUALITY_TOL when
    ``gated``, else printed."""
    b, s = SSM_SERVE
    vocab = cfg.vocab_size
    worst, compared, agreement = logit_error(per_request(res), per_request(gemm), vocab)
    free_memory()
    kernels.reset_launch_counts()
    forced = forced_err(forced_logits(cfg, params, b, s, gemm["tokens"]), gemm, vocab)
    check_covered(f"serve_ssm/{arch}/{name}/teacher_forced", kernels.launch_state())
    emit("serve_ssm_vs_gemm", arch=arch, config=name, dtype=cfg.dtype, rel_logit_err=worst,
         steps_compared=compared, token_agreement=agreement, forced_rel_logit_err=forced,
         tol=QUALITY_TOL, gated=gated, prefill_ms=res["timings"]["prefill_ms"],
         gemm_prefill_ms=gemm["timings"]["prefill_ms"],
         prefill_speedup=gemm["timings"]["prefill_ms"] / res["timings"]["prefill_ms"],
         decode_ms_per_step=res["timings"]["decode_ms_per_step"],
         gemm_decode_ms_per_step=gemm["timings"]["decode_ms_per_step"])
    if gated and (compared < b or not worst <= QUALITY_TOL or not forced <= QUALITY_TOL):
        raise AssertionError(f"serve_ssm/{arch}/{name}: logit error against gemm {worst} "
                             f"prefix-matched over {compared} steps, {forced} teacher-forced "
                             f"(tolerance {QUALITY_TOL})")


def prefix_run(name: str, cfg, params, requests) -> dict:
    """The engine with the prefix cache: each request's prompt less its
    last two tokens served first (one token each), then every whole prompt,
    which must hit the snapshot of its head (state-bearing snapshots are
    keyed at the whole prompt they prefilled, so a prompt hits only the
    prompts it extends) and reuse all of it. Returns the outputs of the
    whole prompts, as :func:`engine_run`'s."""
    engine = ServeEngine(cfg, params, device=DEV, seed=0, record_logits=True,
                         prefix_cache=True, **ENGINE)
    engine.warm()
    misses = plan_cache.stats().misses
    kernels.reset_launch_counts()
    for p, _ in requests:
        engine.submit(p[:-2], max_new_tokens=1)
    engine.run()
    hits, reused = engine.stats.prefix_hits, engine.stats.prefix_tokens_reused
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in requests]
    engine.run()
    state = kernels.launch_state()
    hits, reused = engine.stats.prefix_hits - hits, engine.stats.prefix_tokens_reused - reused
    want = sum(len(p) - 2 for p, _ in requests)
    plan_misses = plan_cache.stats().misses - misses
    emit("serve_engine_prefix", config=name, requests=len(reqs), prefix_hits=hits,
         prefix_tokens_reused=reused, expected_tokens_reused=want,
         plan_misses_after_warm=plan_misses, sample=reqs[0].generated)
    check_covered(f"serve_engine/{name}", state)
    if hits != len(requests) or reused != want or plan_misses:
        raise AssertionError(f"serve_engine/{name}: {hits} prefix hits reusing {reused} "
                             f"tokens (expected {len(requests)}, {want}), {plan_misses} plan "
                             "misses after warm")
    out = {"outputs": [(r.generated, r.logits) for r in reqs]}
    del engine, reqs
    free_memory()
    return out


def phase_serve_engine_ssm() -> None:
    """The continuous-batching ServeEngine on each SSM and hybrid arch at
    published width and SSM_DEPTH layers (seed 0), the 16 requests of phase
    serve_engine over 8 slots. In bf16, the published dtype: auto mode and
    forced strassen, each with every bucket's step a CUDA graph, no
    plan-cache miss after warm (:func:`engine_run`). The comparisons run at
    the first layers (:func:`twin_depth`): each mode with graphs and
    eagerly (:func:`twin_check`: the real slots' recurrent state
    bit-equal too), the graphs' outputs compared with the same requests
    served one at a time through the one-shot steps with every product on
    torch.matmul (:func:`oneshot_reference` in gemm mode, the fp
    reference), prefix-matched, printed (SSM_HELD); then on the weights in
    SSM_HELD (float32), graphs on: auto and forced, each held to that
    dtype's one-shot within QUALITY_TOL, prefix-matched; and auto with
    16-token chunked prefill (the recurrent state carried from chunk to
    chunk through the slot cache) and with the prefix cache
    (:func:`prefix_run`), each held to the plain auto engine within
    QUALITY_TOL. Whether every token is equal is printed for each pair.
    Every launch is at a shape phase_kernels checked."""
    for arch in SSM_ARCHS:
        base = ssm_served(arch)
        vocab = base.vocab_size
        free_memory()
        params = M.init_params(base, 0, DEV)
        requests = engine_requests(vocab)
        cut, cut_params = cut_depth(base, params, twin_depth(base))
        layers = cut.num_layers
        one = oneshot_reference(dataclasses.replace(cut, falcon_mode="gemm"), cut_params,
                                requests)
        for name, mode in (("auto", "auto"), ("forced", "strassen")):
            cfg = dataclasses.replace(base, falcon_mode=mode)
            graph = engine_run(f"{arch}/{name}", cfg, params, requests, True)
            check_covered(f"serve_engine/{arch}/{name}", graph["state"])
            if name == "forced" and min(graph["counts"][k] for k in ENGINE_FP_KERNELS) <= 0:
                raise AssertionError(f"serve_engine/{arch}/forced: a kernel of the path never "
                                     f"launched: {graph['counts']}")
            del graph
            twin, eager = twin_check(f"{arch}/{name}", cfg, params, requests)
            check_covered(f"serve_engine/{arch}/{name}/twins", eager["state"])
            engine_vs(f"serve_engine/{arch}/{name}@{layers}L/oneshot", twin["outputs"], one,
                      vocab, gated=False)
            del twin, eager
            free_memory()
        # in SSM_HELD: auto and forced against the one-shot, chunked and
        # prefix-cached prefill against plain auto
        held, p = dataclasses.replace(cut, dtype=SSM_HELD), as_dtype(cut_params, SSM_HELD)
        del params, cut_params, one
        one = oneshot_reference(dataclasses.replace(held, falcon_mode="gemm"), p, requests)
        plain = None
        for name, mode in (("auto", "auto"), ("forced", "strassen")):
            tag = f"{arch}/{name}_{SSM_HELD}@{layers}L"
            run_ = engine_run(tag, dataclasses.replace(held, falcon_mode=mode), p, requests,
                              True, profile=False)
            check_covered(f"serve_engine/{tag}", run_["state"])
            engine_vs(f"serve_engine/{tag}/oneshot", run_["outputs"], one, vocab, gated=True)
            plain = plain or run_["outputs"]
            del run_
        chunked = engine_run(f"{arch}/auto_{SSM_HELD}_chunked@{layers}L", held, p, requests,
                             True, profile=False, prefill_chunk=ENGINE_SPEC["prefill_chunk"])
        check_covered(f"serve_engine/{arch}/auto_{SSM_HELD}_chunked", chunked["state"])
        prefix = prefix_run(f"{arch}/auto_{SSM_HELD}_prefix@{layers}L", held, p, requests)
        for tag, run_ in (("chunked", chunked), ("prefix", prefix)):
            engine_vs(f"serve_engine/{arch}/auto_{SSM_HELD}_{tag}@{layers}L", run_["outputs"],
                      plain, vocab, gated=True)
        del p, chunked, prefix, plain, one
        free_memory()


def engine_vs(what: str, got: list, want: list, vocab: int, gated: bool) -> None:
    """Engine outputs against another run's, each (tokens, logits per step)
    per request: whether every token is equal, and the prefix-matched logit
    error (:func:`logit_error`), held within QUALITY_TOL when ``gated``."""
    worst, compared, agreement = logit_error(got, want, vocab)
    emit("serve_engine_ssm_vs", of=what, identical_tokens=all(
        a[0] == b[0] for a, b in zip(got, want)), token_agreement=agreement,
         rel_logit_err=worst, steps_compared=compared, tol=QUALITY_TOL, gated=gated)
    if gated and (compared < len(got) or not worst <= QUALITY_TOL):
        raise AssertionError(f"{what}: logit error {worst} over {compared} steps "
                             f"(tolerance {QUALITY_TOL})")


# ---------------------------------------------------------------------------
# The audio and vlm frontends (musicgen_large, pixtral_12b), and checkpoints
# ---------------------------------------------------------------------------

FE_ARCHS = ("musicgen_large", "pixtral_12b")
# One-shot (batch, text tokens, new tokens): musicgen's tokens carry its 4
# codebooks; pixtral's text follows 1,024 image patches, 4 x 1,536 = 6,144
# prefill rows
FE_SERVE = {"musicgen_large": (4, 512, 16), "pixtral_12b": (4, 512, 8)}
# (run, mode, int8 tier): forced strassen on pixtral would hold ~43 GB of B̃
# beside its 24 GB of weights, so it serves gemm and auto only
FE_RUNS = {"musicgen_large": (("gemm", "gemm", False), ("auto", "auto", False),
                              ("forced", "strassen", False), ("forced_int8", "strassen", True)),
           "pixtral_12b": (("gemm", "gemm", False), ("auto", "auto", False))}
CKPT_LAYERS = 4         # phase checkpoint: musicgen at full width, cut to 4 layers
CKPT_DIR = os.path.join(ROOT, "build", "checkpoint")


def fe_contexts(cfg) -> list[tuple[int, int, int, bool, int]]:
    """(batch, tokens per row, cache length, decode, m_hint) of every call
    a frontend arch's one-shot serves make: the prefill and the decode
    steps against its cache (patches + text + new tokens), for the measured
    serve and its 2-token warm-up. ``m_hint``: the text rows, which the
    launcher prices its offline Combine B at."""
    b, s, gen = FE_SERVE[cfg.name]
    patches = cfg.num_patches if cfg.frontend == "vision_patches" else 0
    return sorted({(b, n, patches + s + g, n == 1, b * s) for n in (s, 1) for g in (gen, 2)})


def fe_launches(arch: str) -> set[tuple]:
    """:func:`planned_launches` of every run of phase serve_frontends and,
    for musicgen, of phase checkpoint."""
    base = get_config(arch)
    out = set()
    for _, mode, quant in FE_RUNS[arch]:
        if mode != "gemm":
            out |= planned_launches(base, mode, fe_contexts(base), quantize=quant)
    if arch == "musicgen_large":
        cut = dataclasses.replace(base, num_layers=CKPT_LAYERS)
        out |= planned_launches(cut, "strassen", fe_contexts(cut))
    return out


def fe_kernel_cases() -> list[tuple[str, str, torch.dtype, dict, object]]:
    """:func:`launch_kernel_cases` of the frontend phases' calls of #1-#4:
    musicgen's projections and codebook heads (#1, #3; the heads' offline
    Combine B over the codebook stack, #2), its attention over 4 x 32
    groups (#2, #4), each leaf's offline Combine B over the layers (#2)
    and, under --quant, each slice's (#1); pixtral's planned leaves at its
    6,144-row prefill."""
    return launch_kernel_cases({arch: fe_launches(arch) for arch in FE_ARCHS})


def fe_leaves(cfg, hint: int, quantize: bool = False) -> dict[str, tuple[int, int, object]]:
    """:func:`planned_leaves`, with an audio arch's codebook head (a static
    leaf, planned at ``hint`` as the others)."""
    out = planned_leaves(cfg, hint)
    if cfg.frontend == "audio_codebooks":
        K, N = cfg.d_model, M.padded_vocab(cfg)
        fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=quantize)
        d = falcon.plan(hint, K, N, fcfg, cfg.dtype, precombined_b=True)
        if d.use_lcma:
            out["lm_head"] = (K, N, d)
    return out


def fe_decisions(cfg, hint: int, rows: int, batch: int, quantize: bool) -> dict:
    """Each leaf's decision (and the tied head's): planned at ``hint``
    rows, and as the dispatch re-decides it at the prefill's ``rows`` and
    at a decode step's ``batch`` rows."""
    fcfg = dataclasses.replace(M.falcon_config_for(cfg), quantize=quantize)
    out = {}
    for path, (K, N) in arch_leaves(cfg, lm_head=True).items():
        if path == "lm_head" and cfg.tie_embeddings:
            out[path] = {f"M={m}": describe(falcon.plan(m, K, N, fcfg, cfg.dtype))
                         for m in (batch, rows)}
            continue
        d = falcon.plan(hint, K, N, fcfg, cfg.dtype, precombined_b=True)
        out[path] = {"planned": describe(d)}
        if d.use_lcma and cfg.falcon_mode == "auto":
            re = dataclasses.replace(fcfg, mode="auto", candidates=(d.algo.name,))
            out[path].update({f"M={m}": describe(falcon.plan(m, K, N, re, cfg.dtype,
                                                             precombined_b=True))
                              for m in (batch, rows)})
    return out


def phase_serve_frontends() -> dict:
    """The audio and vlm archs at full width and published depth, bf16,
    random weights from seed 0, served one-shot (FE_SERVE), each run after
    a 2-token warm-up serve: musicgen_large (48 layers, 4 x 512 tokens of 4
    codebooks, 16 new) in gemm mode (every product on torch.matmul, the
    reference), auto, forced strassen (#1/#3 on every projection and each
    codebook's head, #2/#4 on attention) and forced strassen with the int8
    tier (#6/#7 on every projection and head, the codebook-stacked B̃q);
    pixtral_12b (40 layers, 4 x (1,024 patches + 512 text), 8 new) in gemm
    and auto. Each run prints its times, peak bytes, each leaf's decision
    and its launches; each non-gemm run is held to gemm within
    QUALITY_TOL, prefix-matched and teacher-forced on gemm's tokens, over
    all codebooks. Every launch of #1-#4, #6 and #7 is at a shape the
    kernel phases checked. Returns the forced runs' launches of #1/#3 and
    #6/#7 (the ``@codebook_head`` entries of the kernels line)."""
    fe_counts = {}
    for arch in FE_ARCHS:
        base = get_config(arch)
        batch, prompt, gen = FE_SERVE[arch]
        patches = base.num_patches if base.frontend == "vision_patches" else 0
        rows, hint, vocab = batch * (patches + prompt), batch * prompt, base.vocab_size
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        params = M.init_params(base, 0, DEV)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        emit("serve_frontends_weights", arch=arch, layers=base.num_layers, weight_bytes=held,
             init_transient_bytes=torch.cuda.max_memory_allocated() - before - held,
             frontend=base.frontend, prefill_rows=rows)
        runs = {}
        for name, mode, quant in FE_RUNS[arch]:
            cfg = dataclasses.replace(base, falcon_mode=mode)
            planned = {path: describe(d) for path, (_, _, d)
                       in fe_leaves(cfg, hint, quant).items()} if mode != "gemm" else {}
            kernels.reset_launch_counts()
            run_oneshot(cfg, batch=batch, prompt_len=prompt, gen=2, seed=0, device=DEV,
                        params=params, quantize=quant)
            check_covered(f"serve_frontends/{arch}/{name}/warm-up", kernels.launch_state())
            free_memory()
            res, counts = serve("serve_frontends", cfg, params, quantize=quant, batch=batch,
                                prompt=prompt, gen=gen, config=name, planned=planned,
                                prefill_rows=rows,
                                decisions=fe_decisions(cfg, hint, rows, batch, quant))
            check_covered(f"serve_frontends/{arch}/{name}", kernels.launch_state())
            runs[name] = res
            if mode == "gemm" and (res["n_precombined"] or sum(counts.values())):
                raise AssertionError(f"serve_frontends/{arch}/gemm: precombined "
                                     f"{res['n_precombined']}, launches {counts}")
            if mode != "gemm" and res["n_precombined"] != len(planned):
                raise AssertionError(f"serve_frontends/{arch}/{name}: {res['n_precombined']} "
                                     f"leaves precombined, the pricing names {planned}")
            want = {"forced": ENGINE_FP_KERNELS,
                    "forced_int8": ("batched_group_combine", "batched_fused_gemm_combine_h",
                                    "group_combine_quant", "fused_gemm_combine_h_quant"),
                    "auto": ("group_combine", "fused_gemm_combine_h") if planned else ()}
            if min((counts[k] for k in want.get(name, ())), default=1) <= 0:
                raise AssertionError(f"serve_frontends/{arch}/{name}: a kernel of the path "
                                     f"never launched: {counts}")
            if arch == "musicgen_large" and name in ("forced", "forced_int8"):
                fe_counts.update({k: counts[k] for k in want[name]})
            if mode != "gemm":
                err_ = quality(f"serve_frontends/{arch}/{name}", per_request(res),
                               per_request(runs["gemm"]), vocab)
                free_memory()
                kernels.reset_launch_counts()
                forced = forced_err(forced_logits(cfg, params, batch, prompt,
                                                  runs["gemm"]["tokens"], quantize=quant),
                                    runs["gemm"], vocab)
                check_covered(f"serve_frontends/{arch}/{name}/teacher_forced",
                              kernels.launch_state())
                emit("serve_frontends_vs_gemm", arch=arch, config=name, rel_logit_err=err_,
                     forced_rel_logit_err=forced, steps_compared=batch * gen,
                     tol=QUALITY_TOL, prefill_ms=res["timings"]["prefill_ms"],
                     gemm_prefill_ms=runs["gemm"]["timings"]["prefill_ms"],
                     prefill_speedup=runs["gemm"]["timings"]["prefill_ms"]
                     / res["timings"]["prefill_ms"],
                     decode_ms_per_step=res["timings"]["decode_ms_per_step"],
                     gemm_decode_ms_per_step=runs["gemm"]["timings"]["decode_ms_per_step"])
                if not forced <= QUALITY_TOL:
                    raise AssertionError(f"serve_frontends/{arch}/{name}: teacher-forced "
                                         f"logit error against gemm {forced} > {QUALITY_TOL}")
                runs.pop(name)
            del res
            free_memory()
        del params, runs
        free_memory()
    return fe_counts


def phase_checkpoint() -> None:
    """musicgen_large at full width, cut to CKPT_LAYERS layers (bf16, seed
    0), served forced one-shot as phase serve_frontends serves it, saved
    with the port's ``save_checkpoint`` (manifest + npz, bf16 as uint16, a
    sha256 of the payload, an atomic rename), its weights freed, restored
    to the card and served again: the same tokens and bit-equal logits at
    every step. Then one flipped byte of the payload must fail the restore's
    integrity check."""
    base = dataclasses.replace(get_config("musicgen_large"), num_layers=CKPT_LAYERS,
                               falcon_mode="strassen")
    batch, prompt, gen = FE_SERVE[base.name]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free_memory()
    params = M.init_params(base, 0, DEV)
    first, _ = serve("checkpoint_serve", base, params, batch=batch, prompt=prompt, gen=gen,
                     config="before_save")
    check_covered("checkpoint/before_save", kernels.launch_state())
    t0 = time.perf_counter()
    path = save_checkpoint(CKPT_DIR, 1, params, extra={"arch": base.name})
    t_save = time.perf_counter() - t0
    # the structure alone names the keys: the weights leave the card first
    like = strip(params)
    del params
    free_memory()
    t0 = time.perf_counter()
    restored, step, extra = restore_checkpoint(CKPT_DIR, like, device=DEV)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    if step != 1 or extra != {"arch": base.name} or strip(restored) != like:
        raise AssertionError(f"checkpoint: restored step {step}, extra {extra}, dtypes "
                             f"{strip(restored)}")
    second, _ = serve("checkpoint_serve", base, restored, batch=batch, prompt=prompt, gen=gen,
                      config="restored")
    check_covered("checkpoint/restored", kernels.launch_state())
    same_tokens = torch.equal(first["tokens"], second["tokens"])
    same_logits = all(torch.equal(a, b) for a, b in zip(first["logits"], second["logits"],
                                                         strict=True))
    del restored, first, second
    free_memory()
    npz = os.path.join(path, "arrays.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)[0]
        f.seek(size // 2)
        f.write(bytes([byte ^ 0xFF]))
    try:
        restore_checkpoint(CKPT_DIR, like, device="cpu")
        detected = False
    except IOError as e:
        detected = "integrity" in str(e)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit("checkpoint", arch=base.name, layers=base.num_layers, payload_bytes=size,
         save_s=t_save, restore_s=t_restore, identical_tokens=same_tokens,
         identical_logits=same_logits, corruption_detected=detected)
    if not (same_tokens and same_logits and detected):
        raise AssertionError(f"checkpoint: identical tokens {same_tokens}, logits "
                             f"{same_logits}, corruption detected {detected}")


def strip(tree):
    """The nested dict's structure, each tensor replaced by its dtype (a leaf
    that names a key, as ``restore_checkpoint`` reads it)."""
    return {k: strip(v) if isinstance(v, dict) else v.dtype for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Multi-device serving: granite_3_2b tensor-parallel and one dbrx_132b MoE
# layer expert-parallel over 2 ranks, both processes on the one card
# ---------------------------------------------------------------------------

MESH = {"data": 1, "model": 2}
MESH_ARCH = "granite_3_2b"
MESH_MODES = ("gemm", "auto", "strassen")
MESH_F32_LAYERS = 2             # the float32 comparison: granite cut to 2 layers
MESH_F32_TOL = 1e-4             # max |mesh - one device| / max |one device|, float32
MESH_MOE = "dbrx_132b"
MESH_DIR = os.path.join(ROOT, "build", "mesh")
# A gloo mesh of ranks sharing one card: its collectives cross pinned host
# memory, so what it measures is that path, never a link's rate.
MESH_LABEL = "gloo, 2 ranks sharing one card"


def mesh_contexts(cfg) -> dict[str, list]:
    """(batch, tokens per row, cache length, decode, m_hint) of every call
    the ranks make: the one-shot's prefill and decode against its 80-key
    cache (66 keys: the 2-token warm-up serve), and (``engine``) every
    prefill and decode bucket of the 8-layer engine against the slot cache."""
    oneshot = [(BATCH, n, PROMPT + gen, n == 1, BATCH * PROMPT)
               for n in (PROMPT, 1) for gen in (GEN, 2)]
    pol = engine_policy(False)
    hint, keys = pol.prefill_batch[-1] * pol.prefill_seq[-1], engine_keys(False)
    engine = ([(rows, n, keys, False, hint) for rows, n in pol.prefill_shapes()]
              + [(rows, 1, keys, True, hint) for rows in pol.decode_batch])
    return {"oneshot": oneshot, "engine": engine}


def mesh_moe_capacity(cfg) -> int:
    return workloads.layer_capacity(cfg, MOE_LAYER_T)


def tp_kernel_cases() -> list[tuple[str, str, torch.dtype, dict, object]]:
    """(kernel, scheme, dtype, shape fields, check) of every call of #1-#4
    one rank of the meshes that serve granite makes (:func:`planned_launches`
    at the shapes a rank contracts: ``@tp`` the 1 x 2 mesh's shards, ``@dp``
    the 2 x 1 mesh's rows, phase train_mesh's data runs): granite's one-shot
    in auto mode and forced strassen and its 8-layer engine forced (bf16),
    the float32 one-shot at 2 layers and engine at 8, forced; and the
    expert-parallel dbrx layer's grouped calls at 8 experts a rank: Combine
    B of each rank's expert stacks and Combine A of the activations at its
    capacity (#2), the grouped product against per-expert B̃ (#4)."""
    base = get_config(MESH_ARCH)
    ctx = mesh_contexts(base)
    keys = {}
    for tag, shape in (("tp", MESH), ("dp", DP_MESH)):
        bf16 = set().union(*(planned_launches(base, mode, ctx["oneshot"], mesh_shape=shape)
                             for mode in ("auto", "strassen")))
        bf16 |= planned_launches(dataclasses.replace(base, num_layers=TWIN_LAYERS),
                                 "strassen", ctx["engine"], mesh_shape=shape)
        f32 = planned_launches(dataclasses.replace(base, num_layers=MESH_F32_LAYERS,
                                                   dtype="float32"), "strassen",
                               ctx["oneshot"], mesh_shape=shape)
        f32 |= planned_launches(dataclasses.replace(base, num_layers=TWIN_LAYERS,
                                                    dtype="float32"),
                                "strassen", ctx["engine"], mesh_shape=shape)
        keys.update({f"{MESH_ARCH}@{tag}": bf16, f"{MESH_ARCH}@{tag}_f32": f32})
    out = [(name, scheme, dt,
            {**fields, **({"dp": DP_MESH["data"]} if "@dp" in fields["arch"]
                          else {"tp": MESH["model"]})}, check)
           for name, scheme, dt, fields, check in launch_kernel_cases(keys)]
    l = alg.get("strassen")
    cfg = get_config(MESH_MOE)
    E, d, ff = cfg.num_experts // MESH["model"], cfg.d_model, cfg.d_ff
    X = cdiv(mesh_moe_capacity(cfg), l.m)
    fields = {"arch": MESH_MOE, "ep": MESH["model"]}
    for K, N in ((d, ff), (ff, d)):
        out.append(("batched_group_combine", l.name, torch.bfloat16,
                    {**fields, "stack": [E, K, N]},
                    functools.partial(check_stacked_combine, l, E, K, N)))
        out.append(("batched_group_combine", l.name, torch.bfloat16,
                    {**fields, "activations": [E, 2 * X, K]},
                    checked(functools.partial(combine_case, l, torch.bfloat16, (2 * X, K), "U",
                                              groups=E))))
        out.append(("batched_fused_gemm_combine_h", l.name, torch.bfloat16,
                    {**fields, "per_group_bt": [E, l.R, K // 2, N // 2], "X": X},
                    functools.partial(check_grouped_fused, l, E, X, K // 2, N // 2)))
    return out


def mesh_engine(dtype: str, mesh=None) -> dict:
    """granite's ServeEngine at TWIN_LAYERS layers, forced strassen, eager
    steps, in ``dtype``, on one device or, with ``mesh``, on this rank of
    its mesh (1 x 2: tensor parallel; 2 x 1: the data axis):
    phase serve_engine's 16 requests served after warm, with their launch
    counts (set to 0 after warm) and the plan misses serving added."""
    cfg = dataclasses.replace(get_config(MESH_ARCH), num_layers=TWIN_LAYERS,
                              falcon_mode="strassen", dtype=dtype)
    engine = ServeEngine(cfg, M.init_params(cfg, 0, DEV), device=DEV, cuda_graphs=False,
                         record_logits=True,
                         mesh_shape=dict(mesh.shape) if mesh is not None else None,
                         **ENGINE)
    warm = engine.warm()
    misses = plan_cache.stats().misses
    kernels.reset_launch_counts()
    if mesh is not None:
        mesh.stats.reset()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in engine_requests(cfg.vocab_size)]
    engine.run()
    torch.cuda.synchronize()
    out = {"outputs": [(r.generated, r.logits) for r in reqs],
           "seconds": time.perf_counter() - t0, "warm": warm,
           "misses_after_warm": plan_cache.stats().misses - misses,
           "launches": kernels.launch_counts(), "state": dict(kernels.launch_state()),
           "summary": {k: v for k, v in engine.summary().items() if k != "prefix_cache"}}
    del engine
    free_memory()
    return out


def mesh_moe_layer(cfg, mode: str, mesh=None) -> dict:
    """One full-width dbrx MoE layer (random bf16 weights and a 4 x 512
    input drawn from seed 0, as phase moe_layer's) under ``mode``, on one
    device or, with ``mesh``, expert-parallel on this rank: its output, the
    routes, launches and launch_state, and the device ms per call."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    p = MOE.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, torch.bfloat16, DEV)
    x = randn(4, MOE_LAYER_T // 4, cfg.d_model, dtype=torch.bfloat16, gen=gen)
    if mesh is not None:
        p = SH.shard_params(p, cfg, mesh)
        free_memory()
    seen = {}
    route = MOE._route

    def rec_route(*a):
        out = route(*a)
        seen["idx"] = out[2]
        return out

    fn = lambda: MOE.moe_apply(p, x, cfg.experts_per_token, cfg.capacity_factor,  # noqa: E731
                               deterministic_capacity=mesh_moe_capacity(cfg),
                               num_experts=cfg.num_experts)
    with falcon.use(falcon.FalconConfig(mode=mode)), PM.use_mesh(mesh), \
            torch.inference_mode():
        kernels.reset_launch_counts()
        MOE._route = rec_route
        try:
            y, aux = fn()
            torch.cuda.synchronize()
        finally:
            MOE._route = route
        counts, state = kernels.launch_counts(), dict(kernels.launch_state())
        t = events_ms(fn, warmup=1, launches=3, runs=3)[0]
    return {"y": y.cpu(), "aux": float(aux), "idx": seen["idx"].cpu(), "counts": counts,
            "state": state, "ms": t, "held": p["router"].shape[-1]}


def serve_runs(mesh, refs: dict) -> dict:
    """granite's serving runs on this rank of ``mesh`` (1 x 2 in phase
    serve_mesh, 2 x 1 in phase train_mesh's spawn), each held to one device
    by :func:`check_serve_runs`: the one-shot at published depth in
    MESH_MODES (with a 2-token warm-up serve, and teacher-forced on the
    one-device tokens ``refs["oneshot"]``), at MESH_F32_LAYERS in float32,
    and the TWIN_LAYERS engine in both dtypes. Each run's launch counts are
    set to 0 just before it and read just after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    shape = dict(mesh.shape)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "oneshot": {}, "f32": {}}
    base = get_config(MESH_ARCH)
    params = M.init_params(base, 0, DEV)
    for mode in MESH_MODES:
        cfg = dataclasses.replace(base, falcon_mode=mode)
        run_oneshot(cfg, batch=BATCH, prompt_len=PROMPT, gen=2, seed=0, device=DEV,
                    params=params, mesh_shape=shape)            # warm-up
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        mesh.stats.reset()
        res = run_oneshot(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0, device=DEV,
                          params=params, mesh_shape=shape)
        counts, state = kernels.launch_counts(), dict(kernels.launch_state())
        out["oneshot"][mode] = {
            "tokens": res["tokens"], "logits": [lg.float().cpu() for lg in res["logits"]],
            "timings": res["timings"], "launches": counts, "state": state,
            "launches_by_phase": res["launches"], "mesh": res["mesh"],
            "n_precombined": res["n_precombined"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "forced": forced_logits(cfg, params, BATCH, PROMPT, refs["oneshot"][mode],
                                    mesh_shape=shape)}
        free_memory()
    del params
    free_memory()
    f32 = dataclasses.replace(base, num_layers=MESH_F32_LAYERS, dtype="float32")
    params = M.init_params(f32, 0, DEV)
    for mode in ("gemm", "strassen"):
        kernels.reset_launch_counts()
        res = run_oneshot(dataclasses.replace(f32, falcon_mode=mode), batch=BATCH,
                          prompt_len=PROMPT, gen=GEN, seed=0, device=DEV, params=params,
                          mesh_shape=shape)
        out["f32"][mode] = {"tokens": res["tokens"],
                            "logits": [lg.float().cpu() for lg in res["logits"]],
                            "state": dict(kernels.launch_state())}
    del params
    free_memory()
    out["engine"] = {dt: mesh_engine(dt, mesh) for dt in ("float32", "bfloat16")}
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank(mesh, refs: dict) -> dict:
    """One rank of the 1 x 2 mesh (spawned by phase serve_mesh): the serving
    runs (:func:`serve_runs`), then one dbrx MoE layer expert-parallel, the
    collective probe and phase train_mesh's tensor-parallel jobs, each with
    its launch counts set to 0 just before it and read just after."""
    out = serve_runs(mesh, refs)
    moe = get_config(MESH_MOE)
    out["moe"] = {mode: mesh_moe_layer(moe, mode, mesh) for mode in ("gemm", "strassen")}
    free_memory()
    # (d) the collective probe, and whether gloo takes CUDA tensors itself
    import torch.distributed as dist
    direct = {}
    for op in ("all_reduce", "all_gather"):
        x = torch.ones(4, device=DEV)
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
            else:
                dist.all_gather([torch.empty_like(x) for _ in range(mesh.n_devices)], x)
            torch.cuda.synchronize()
            direct[op] = "works"
        except RuntimeError as e:
            direct[op] = f"raises: {str(e).splitlines()[0][:160]}"
    out["probe"] = {"collective_bw": measure_collective_bw(), "gloo_cuda_tensors": direct}
    # phase train_mesh's tensor-parallel runs, on these ranks
    out["train"] = train_mesh_jobs(mesh, refs.get("train", []))
    return out


def mesh_check(what: str, got: dict, want: dict, vocab: int) -> tuple[float, float]:
    """A mesh run against the one-device run of the same weights: (prefix-
    matched relative logit error, teacher-forced one), each held to
    QUALITY_TOL."""
    pre, compared, agreement = logit_error(per_request(got), per_request(want), vocab)
    forced = forced_err(got["forced"], want, vocab)
    if compared < len(want["tokens"]) or not max(pre, forced) <= QUALITY_TOL:
        raise AssertionError(f"{what}: logit error against one device {pre} "
                             f"(prefix, {compared} steps), {forced} (teacher-forced), "
                             f"tolerance {QUALITY_TOL}")
    return pre, forced, agreement


MESH_SINGLES: dict = {}


def mesh_singles() -> dict:
    """One device's runs that :func:`serve_runs` is held to (computed once,
    phase train_mesh's data runs and phase serve_mesh share them): the
    one-shot per mode at published depth (with its 2-token warm-up serve),
    the float32 one-shot's logits at MESH_F32_LAYERS, and the engine's
    outputs in both dtypes."""
    if MESH_SINGLES:
        return MESH_SINGLES
    base = get_config(MESH_ARCH)
    singles = {}
    params = M.init_params(base, 0, DEV)
    for mode in MESH_MODES:
        cfg = dataclasses.replace(base, falcon_mode=mode)
        run_oneshot(cfg, batch=BATCH, prompt_len=PROMPT, gen=2, seed=0, device=DEV,
                    params=params)                              # warm-up
        res = run_oneshot(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0, device=DEV,
                          params=params)
        singles[mode] = {"tokens": res["tokens"], "timings": res["timings"],
                         "logits": [lg.float().cpu() for lg in res["logits"]]}
        free_memory()
    del params
    f32 = dataclasses.replace(base, num_layers=MESH_F32_LAYERS, dtype="float32")
    params = M.init_params(f32, 0, DEV)
    f32_single = {mode: run_oneshot(dataclasses.replace(f32, falcon_mode=mode), batch=BATCH,
                                    prompt_len=PROMPT, gen=GEN, seed=0, device=DEV,
                                    params=params)["logits"]
                  for mode in ("gemm", "strassen")}
    del params
    engine_single = {dt: mesh_engine(dt)["outputs"] for dt in ("float32", "bfloat16")}
    free_memory()
    MESH_SINGLES.update(oneshot=singles, f32=f32_single, engine=engine_single)
    return MESH_SINGLES


def check_serve_runs(line: str, ranks: list, mesh_shape: dict, label: str) -> None:
    """Hold each rank's :func:`serve_runs` to one device
    (:func:`mesh_singles`): every launch of #1-#4 at a checked shape and
    every rank serving the same tokens; the one-shot per mode prefix-matched
    and teacher-forced within QUALITY_TOL (forced strassen through #1-#4 on
    every rank), in float32 within MESH_F32_TOL; the engine in float32 to
    equal tokens and MESH_F32_TOL, in bf16 prefix-matched within
    QUALITY_TOL, with no plan missed after warm. Lines ``<line>``,
    ``<line>_f32``, ``<line>_engine``; each one-shot line gives per rank
    the prefill ms, decode ms a step, tokens/s of the whole batch, staged
    bytes and the collectives' ms and calls."""
    one = mesh_singles()
    base = get_config(MESH_ARCH)
    V = base.vocab_size
    r0 = ranks[0]
    # (a) one-shot granite, each mode against one device
    for mode in MESH_MODES:
        runs = [r["oneshot"][mode] for r in ranks]
        for i, run in enumerate(runs):
            check_covered(f"{line}/{mode}/rank{i}", collections.Counter(run["state"]))
            if not torch.equal(run["tokens"], runs[0]["tokens"]):
                raise AssertionError(f"{line}/{mode}: rank {i}'s tokens differ from rank 0's")
        run = runs[0]
        pre, forced, agreement = mesh_check(f"{line}/{mode}", run, one["oneshot"][mode], V)
        emit(line, arch=MESH_ARCH, layers=base.num_layers, dtype=base.dtype, mode=mode,
             mesh=mesh_shape, label=label, backend=r0["backend"], batch=BATCH,
             prompt_len=PROMPT, new_tokens=GEN, n_precombined=run["n_precombined"],
             rel_logit_err=pre, forced_rel_logit_err=forced, token_agreement=agreement,
             tol=QUALITY_TOL, **run["timings"],
             single_device=one["oneshot"][mode]["timings"],
             timings_by_rank=[r["timings"] for r in runs],
             launches_by_rank=[r["launches"] for r in runs],
             launches_by_phase=run["launches_by_phase"],
             staged_bytes=run["mesh"]["staged_bytes"],
             collective_ms=run["mesh"]["collective_ms"],
             collective_calls=run["mesh"]["collective_calls"],
             staged_bytes_by_rank=[r["mesh"]["staged_bytes"] for r in runs],
             collective_ms_by_rank=[r["mesh"]["collective_ms"] for r in runs],
             collective_calls_by_rank=[r["mesh"]["collective_calls"] for r in runs],
             collectives_by_phase=run["mesh"]["collectives"],
             peak_bytes_by_rank=[r["peak_bytes"] for r in runs])
        if mode == "strassen" and min(r["launches"][k] for r in runs
                                      for k in ENGINE_FP_KERNELS) <= 0:
            raise AssertionError(f"{line}/strassen: a rank launched no #1-#4: "
                                 f"{[r['launches'] for r in runs]}")
    # ... and in float32 at 2 layers
    for mode in ("gemm", "strassen"):
        got, want = r0["f32"][mode]["logits"], one["f32"][mode]
        for i, r in enumerate(ranks):
            check_covered(f"{line}/f32/{mode}/rank{i}",
                          collections.Counter(r["f32"][mode]["state"]))
        scale = max(w[..., :V].abs().max().item() for w in want)
        d = max((g[..., :V] - w[..., :V].float().cpu()).abs().max().item()
                for g, w in zip(got, want)) / scale
        emit(f"{line}_f32", arch=MESH_ARCH, layers=MESH_F32_LAYERS, mode=mode,
             mesh=mesh_shape, rel_err=d, tol=MESH_F32_TOL)
        if not d <= MESH_F32_TOL:
            raise AssertionError(f"{line}/f32/{mode}: {d} > {MESH_F32_TOL}")
    # (b) the engine: in float32 the ranks cannot flip a greedy token (tokens
    # equal, logits within MESH_F32_TOL); in bf16 a rank's rounding differs
    # from one device's (its partial sums on a model axis, its rows' GEMM
    # shapes on a data axis), so tokens may part where two logits nearly
    # tie: held prefix-matched
    for dt in ("float32", "bfloat16"):
        e = r0["engine"][dt]
        for i, r in enumerate(ranks):
            check_covered(f"{line}/engine/{dt}/rank{i}",
                          collections.Counter(r["engine"][dt]["state"]))
            if [o[0] for o in r["engine"][dt]["outputs"]] != [o[0] for o in e["outputs"]]:
                raise AssertionError(f"{line}/engine/{dt}: rank {i}'s tokens differ "
                                     "from rank 0's")
        single = one["engine"][dt]
        same = all(g[0] == s_[0] for g, s_ in zip(e["outputs"], single))
        worst, compared, agreement = logit_error(e["outputs"], single, V)
        misses = [r["engine"][dt]["misses_after_warm"] for r in ranks]
        tol = MESH_F32_TOL if dt == "float32" else QUALITY_TOL
        emit(f"{line}_engine", arch=MESH_ARCH, layers=TWIN_LAYERS, dtype=dt,
             mode="strassen", mesh=mesh_shape, requests=ENGINE_REQUESTS, cuda_graphs=False,
             tokens_equal=same, token_agreement=agreement, rel_logit_err=worst,
             steps_compared=compared, tol=tol, misses_after_warm=misses,
             seconds=e["seconds"], seconds_by_rank=[r["engine"][dt]["seconds"] for r in ranks],
             warm=e["warm"], launches=e["launches"], summary=e["summary"])
        if (dt == "float32" and not same) or compared < len(single) or \
                not worst <= tol or any(misses):
            raise AssertionError(f"{line}/engine/{dt}: tokens equal {same}, logit error "
                                 f"{worst} over {compared} steps, misses after warm {misses}")
    emit(f"{line}_seconds", mesh=mesh_shape, seconds_by_rank=[r["seconds"] for r in ranks])


def phase_serve_mesh() -> dict:
    """granite_3_2b served tensor-parallel on a 1 x 2 mesh (full width,
    published depth, bf16, 4 x 64 prompts, 16 new tokens; gemm, auto and
    forced strassen), both ranks spawned on this card over gloo, each run
    held to one-device serving of the same weights prefix-matched and
    teacher-forced (QUALITY_TOL); the same at 2 layers in float32 within
    MESH_F32_TOL; the 8-layer ServeEngine (forced strassen, eager: a
    host-staged collective cannot be captured) on 16 ragged requests held to
    the one-device engine, in float32 to equal tokens and MESH_F32_TOL, in
    bf16 prefix-matched (QUALITY_TOL) (:func:`check_serve_runs`); one
    full-width dbrx MoE layer expert-parallel (8 experts a rank), gemm and
    forced strassen, held to the one-device layer; and the collective probe
    on those ranks. Every rank launch of #1-#4 must be at a shape
    phase_kernels checked. Returns rank 0's launch counts of the forced
    one-shot (``@tp``) and of the forced MoE layer (``@ep``)."""
    one = mesh_singles()
    refs = {"oneshot": {mode: one["oneshot"][mode]["tokens"] for mode in MESH_MODES},
            "train": TRAIN_MESH_REFS.get("jobs", [])}
    moe = get_config(MESH_MOE)
    moe_single = {mode: mesh_moe_layer(moe, mode) for mode in ("gemm", "strassen")}
    free_memory()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = PM.run_ranks(mesh_rank, MESH, refs, backend="gloo", device=DEV, workdir=MESH_DIR,
                         timeout=600)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    check_serve_runs("serve_mesh", ranks, MESH, MESH_LABEL)
    # (c) the expert-parallel MoE layer
    for mode in ("gemm", "strassen"):
        got, want = r0["moe"][mode], moe_single[mode]
        for i, r in enumerate(ranks):
            check_covered(f"serve_mesh/moe/{mode}/rank{i}", collections.Counter(r["moe"][mode]["state"]))
        a, e_ = err(got["y"], want["y"])
        routes = torch.equal(got["idx"], want["idx"])
        emit("serve_mesh_moe", arch=MESH_MOE, mode=mode, mesh=MESH, tokens=MOE_LAYER_T,
             experts_per_rank=got["held"], capacity=mesh_moe_capacity(moe), max_abs_err=a,
             err=e_, tol=LAYER_TOL, routes_equal=routes, ms=got["ms"], single_ms=want["ms"],
             launches_by_rank=[r["moe"][mode]["counts"] for r in ranks],
             single_launches=want["counts"])
        if not e_ <= LAYER_TOL or got["held"] != moe.num_experts // MESH["model"]:
            raise AssertionError(f"serve_mesh/moe/{mode}: error {e_} > {LAYER_TOL} "
                                 f"(routes equal {routes}), {got['held']} experts a rank")
    # (d) the probe
    emit("serve_mesh_probe", label=MESH_LABEL, backend=r0["backend"],
         collective_bw=r0["probe"]["collective_bw"],
         note="ring all-gather / reduce-scatter of 8 MiB over 2 processes on one card, "
              "through pinned host memory: not a link's rate, never saved into a profile",
         gloo_cuda_tensors=r0["probe"]["gloo_cuda_tensors"], spawn_and_ranks_s=spawn_s)
    counts = {f"{k}@tp": v for k, v in r0["oneshot"]["strassen"]["launches"].items()}
    counts.update({f"{k}@ep": v for k, v in r0["moe"]["strassen"]["counts"].items()})
    # phase train_mesh's tensor-parallel runs, held to one device
    if refs["train"]:
        tp = check_train_mesh([r["train"] for r in ranks], TRAIN_MESH_REFS)["tp"]
        counts.update({f"{k}@tp_train": v for k, v in tp.items()})
    return counts


# ---------------------------------------------------------------------------
# Training: granite_3_2b at full width and published depth, the planned
# autograd cores over #1-#4; mamba2_370m's SSD scan in backward
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite_3_2b"
TRAIN = (4, 512)                # batch x tokens of every train step
TRAIN_STEPS = 3                 # AdamW steps per mode, on one batch
TRAIN_MODES = ("gemm", "auto", "strassen")
TRAIN_LR = 3e-4
TRAIN_LOSS_TOL = 0.01           # the first step's loss, auto and forced vs gemm, relative
GRAD_LAYERS = 4                 # the float32 gradient check: granite cut to 4 layers
GRAD_TOL = 1e-3                 # forced vs gemm, relative Frobenius error of each leaf (f32)
SSM_TRAIN_ARCH = "mamba2_370m"
SSM_TRAIN = (4, 512)
TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt")


def train_launches(cfg, mode: str, batch: int, seq: int, mesh_shape=None) -> set[tuple]:
    """Every product a train step of ``cfg`` at (batch, seq) runs as an
    LCMA under ``mode``, decided as ``core.engine``'s planned cores decide
    it: each forward contraction of the registry and its dA and dB
    (``resolve_contractions(train=True)``; with ``mesh_shape``, the shapes
    one rank of that mesh contracts under ``cfg.parallel_style``). The
    weights are raw, so every dense product combines its B at the call; a
    grouped one (attention, the SSD scan) is decided by plan_batched in the
    dtype it runs in. Keys as :func:`planned_launches`'."""
    fcfg = falcon.FalconConfig(mode=mode)
    out = set()
    for c in workloads.resolve_contractions(cfg, batch, seq, train=True, mesh_shape=mesh_shape,
                                            local=bool(mesh_shape)):
        dtype = "float32" if c.kind in workloads.F32_KINDS else cfg.dtype
        if c.group > 1:
            d = falcon.plan_batched(c.group, c.m, c.k, c.n, fcfg, dtype, shared_b=c.shared_b)
            if d.use_lcma:
                out.add(("grouped", d.algo.name, dtype, c.group, c.m, c.k, c.n))
        else:
            d = falcon.plan(c.m, c.k, c.n, fcfg, dtype)
            if d.use_lcma:
                out.add(("dense", d.algo.name, dtype, c.m, c.k, c.n, True))
    return out


def train_configs():
    """(arch, cfg, mode, batch, seq) of every train run of phase train."""
    base = get_config(TRAIN_ARCH)
    f32 = dataclasses.replace(base, dtype="float32", num_layers=GRAD_LAYERS)
    ssm = dataclasses.replace(get_config(SSM_TRAIN_ARCH), dtype="float32")
    return ([(TRAIN_ARCH, base, mode, *TRAIN) for mode in TRAIN_MODES]
            + [(TRAIN_ARCH, f32, mode, *TRAIN) for mode in ("gemm", "strassen")]
            + [(SSM_TRAIN_ARCH, ssm, mode, *SSM_TRAIN) for mode in ("gemm", "strassen")])


def train_kernel_cases() -> list[tuple[str, str, torch.dtype, dict, object]]:
    """:func:`launch_kernel_cases` of every call of #1-#4 phase train makes
    (:func:`train_launches` of each run): granite's projections, tied LM
    head and attention forward and in both backward contractions, bf16 and
    (the gradient check) float32; mamba2's SSD contractions and
    projections in float32."""
    arch_keys: dict[str, set] = {}
    for arch, cfg, mode, b, s in train_configs():
        arch_keys.setdefault(arch, set()).update(train_launches(cfg, mode, b, s))
    return launch_kernel_cases(arch_keys)


class _SameBatch:
    """A data source that gives every step the same batch."""

    def __init__(self, batch: dict):
        self.fixed = batch

    def batch(self, step: int) -> dict:
        return self.fixed


def train_batch(cfg, batch: int, seq: int) -> dict:
    return SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=0), device=DEV).batch(0)


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@contextlib.contextmanager
def captured_grads(keep: bool):
    """Within: each train step's gradients as ``adamw_update`` receives them
    (before clipping): per leaf (finite, Frobenius norm), and with ``keep``
    the first step's tree itself (else its ``embed`` leaf, where there is
    one), under ``"first"``."""
    seen, orig = {"stats": [], "first": None, "update_ms": []}, train_steps.adamw_update

    def update(params, grads, state, cfg, lr_scale=1.0, **kw):
        leaves = flat(grads)
        seen["stats"].append({k: (bool(torch.isfinite(g).all()), float(g.float().norm()))
                              for k, g in leaves.items()})
        if seen["first"] is None:
            seen["first"] = grads if keep else leaves.get("embed", torch.empty(0)).clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(params, grads, state, cfg, lr_scale=lr_scale, **kw)
        torch.cuda.synchronize()
        seen["update_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    train_steps.adamw_update = update
    try:
        yield seen
    finally:
        train_steps.adamw_update = orig


@contextlib.contextmanager
def backward_launches():
    """Within: the kernel launches the planned cores' backward passes make,
    a ``kernels.launch_state`` difference."""
    from repro_torch.core import engine as core_engine
    bwd = collections.Counter()
    cores = (core_engine._PlannedCore, core_engine._GroupedCore)
    orig = [c.__dict__["backward"] for c in cores]

    def counted(f):
        def backward(ctx, g):
            before = kernels.launch_state()
            out = f(ctx, g)
            bwd.update(kernels.launch_state() - before)
            return out
        return staticmethod(backward)

    for c, f in zip(cores, orig):
        c.backward = counted(f.__func__)
    try:
        yield bwd
    finally:
        for c, f in zip(cores, orig):
            c.backward = f


def head_share(params, cfg, batch: dict) -> torch.Tensor:
    """The LM head's share of ``embed``'s gradient alone: the loss's
    gradient through the tied head with the final hidden state held fixed."""
    with torch.no_grad():
        hidden, _ = M.forward(params, cfg, batch["tokens"])
    emb = params["embed"].detach().requires_grad_()
    loss = M.chunked_xent({**params, "embed": emb}, cfg, hidden, batch["labels"])
    (g,) = torch.autograd.grad(loss, [emb])
    return g


def rel_frob(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def train_run(name: str, cfg, batch: dict, steps: int, keep_grads: bool = False,
              profile: bool = False) -> dict:
    """``steps`` AdamW steps of ``cfg`` (weights from seed 0) on ``batch``
    through ``make_train_step`` in a ``TrainLoop``, after ``warm_train``:
    losses, ms per step and tokens/s (host clock, the card synchronized),
    peak memory, launches in all and in the cores' backward, plan-cache
    misses after the warm pass; every step's gradients checked finite and
    nonzero leaf by leaf, and a tied ``embed``'s first one checked to hold
    both its shares; the optimizer's share of a step (``adamw_update``,
    synchronized). Launch counts are reset just before the loop. With
    ``profile``, one more step under torch.profiler (line ``profile_train``:
    the device's busy share and time by kernel)."""
    free_memory()
    params = M.init_params(cfg, 0, DEV)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(params, opt_cfg)
    b, s = batch["tokens"].shape[:2]
    with falcon.use(M.falcon_config_for(cfg)):
        head = head_share(params, cfg, batch) if cfg.tie_embeddings and not keep_grads else None
        t0 = time.perf_counter()
        n_plans = warm_train(cfg, b, s)
        t_warm = time.perf_counter() - t0
        step = make_train_step(cfg, opt_cfg, total_steps=steps + 1, warmup=1)
        loop = TrainLoop(TrainLoopConfig(total_steps=steps + 1, checkpoint_every=10 ** 9,
                                         checkpoint_dir=TRAIN_CKPT, log_every=10 ** 9),
                         step, _SameBatch(batch), params, state)
        misses = plan_cache.stats().misses
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with captured_grads(keep_grads) as grads, backward_launches() as bwd:
            out = loop.run(start_step=1)        # the schedule's step 0 has lr 0
        launches = kernels.launch_state()
        peak = torch.cuda.max_memory_allocated()
        if profile:
            _, prof = profiled(lambda: step(loop.params, loop.opt_state, batch, steps + 1))
            emit("profile_train", name=name, arch=cfg.name, window="one train step", **prof)
    hist = out["history"]
    ms = [h["time"] * 1e3 for h in hist]
    steady = statistics.mean(ms[1:]) if len(ms) > 1 else ms[0]
    res = {"losses": [h["loss"] for h in hist], "ms": ms, "ms_steady": steady,
           "tok_s": b * s / (steady / 1e3), "peak_bytes": peak, "warm_plans": n_plans,
           "warm_s": t_warm, "plan_misses": plan_cache.stats().misses - misses,
           "launches": {k: v for k, v in launches.items() if isinstance(k, str) and v},
           "backward_launches": {k: v for k, v in bwd.items() if isinstance(k, str) and v},
           "update_ms": grads["update_ms"],
           "grad_norms": {k: norm for k, (_, norm) in grads["stats"][0].items()}}
    emit("train", name=name, arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
         mode=cfg.falcon_mode, batch=b, tokens=s, **res)
    bad = [(i, k) for i, st in enumerate(grads["stats"])
           for k, (finite, norm) in st.items() if not finite or norm <= 0]
    if bad or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"train/{name}: non-finite loss or a zero or non-finite "
                             f"gradient (step, leaf): {bad[:8]}")
    if head is not None:
        check_head_share(name, grads["first"], head, batch["tokens"], cfg.vocab_size)
    res["state"], res["grads"] = launches, grads["first"]
    del loop, params, state, head
    return res


def check_head_share(name: str, embed_grad: torch.Tensor, head: torch.Tensor,
                     tokens: torch.Tensor, vocab: int) -> dict:
    """``embed``'s gradient holds both shares: on rows no token looks up it
    is the head's share alone (and nonzero), on looked-up rows the lookup's
    share is added to it."""
    seen = torch.zeros(embed_grad.shape[0], dtype=torch.bool, device=DEV)
    seen[tokens.flatten()] = True
    rest = ~seen
    rest[vocab:] = False                         # the padded rows get no gradient
    head_rows = rel_frob(embed_grad[rest], head[rest])
    lookup_rows = rel_frob(embed_grad[seen], head[seen])
    out = {"unseen_rows_vs_head": head_rows, "seen_rows_vs_head": lookup_rows,
           "unseen_rows_norm": float(embed_grad[rest].float().norm())}
    emit("train_embed_shares", name=name, **out)
    if not (out["unseen_rows_norm"] > 0 and head_rows <= TOL[torch.bfloat16]["fused"]
            and lookup_rows > 10 * TOL[torch.bfloat16]["fused"]):
        raise AssertionError(f"train/{name}: embed's gradient lacks a share: {out}")
    return out


def train_decisions(cfg, batch: int, seq: int) -> dict:
    """What auto mode decides on h100_sxm for each forward, dA and dB shape
    of a train step (forward contractions of the registry at (batch, seq))."""
    fcfg = falcon.FalconConfig(mode="auto")
    out = {}
    for c in workloads.resolve_contractions(cfg, batch, seq):
        if c.group > 1:
            ds = (falcon.plan_batched(c.group, c.m, c.k, c.n, fcfg, cfg.dtype),
                  falcon.plan_batched(c.group, c.m, c.n, c.k, fcfg, cfg.dtype),
                  falcon.plan_batched(c.group, c.k, c.m, c.n, fcfg, cfg.dtype))
        else:
            ds = falcon.plan_training(c.m, c.k, c.n, fcfg, cfg.dtype)
        out[c.role] = {"fwd": describe(ds[0]), "dA": describe(ds[1]), "dB": describe(ds[2]),
                       "shape": [c.group, c.m, c.k, c.n]}
    return out


def transpose_copies(cfg, batch: int, seq: int) -> dict:
    """Device ms of the transposed operands' copies one forced train step
    makes in backward (the pipeline pads and makes each operand contiguous):
    dA's ``w.T`` of each weight and dB's ``a.T`` of each activation, per
    call (CUDA events) and per step (times the layers; the head once)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    bf = getattr(torch, cfg.dtype)
    per_call, per_step = {}, 0.0
    for c in workloads.resolve_contractions(cfg, batch, seq):
        if c.group > 1:
            continue
        n = 1 if c.role == "lm_head" else cfg.num_layers
        w, a = randn(c.k, c.n, dtype=bf, gen=gen), randn(c.m, c.k, dtype=bf, gen=gen)
        tw = events_ms(lambda: w.T.contiguous())[0]
        ta = events_ms(lambda: a.T.contiguous())[0]
        per_call[c.role] = {"w_T_ms": tw, "a_T_ms": ta, "w": [c.k, c.n], "a": [c.m, c.k],
                            "calls_per_step": n}
        per_step += n * (tw + ta)
        del w, a
    out = {"per_call": per_call, "ms_per_step": per_step}
    emit("train_transpose_copies", arch=cfg.name, **out)
    return out


def phase_train() -> dict:
    """granite_3_2b (bf16, full width, published depth, random weights from
    seed 0) trained TRAIN_STEPS AdamW steps (lr 3e-4) on one SyntheticLMData
    batch of 4 x 512 tokens, in gemm, auto and forced strassen, each after
    ``warm_train``: every leaf's gradient finite and nonzero at every step,
    ``embed`` with both its shares, the first loss of auto and forced
    within 1% of gemm's, forced strassen's backward launching #1/#3 and
    #2/#4, every launch at a checked shape and no plan missed after the
    warm pass. Then the gradient in float32 (TF32 off): granite cut to
    GRAD_LAYERS layers, each leaf's forced gradient within GRAD_TOL
    (relative Frobenius) of gemm's; and mamba2_370m at published width and
    depth in float32, one step gemm and forced (the SSD scan's grouped f32
    route of #2/#4 in backward), its gradients held as granite's at its
    first GRAD_LAYERS layers. At published depth they are printed beside
    gemm's own sensitivity to one ulp of its weights: the random-init stack
    amplifies f32 rounding with depth, one ulp of the weights as much as
    strassen's rounding. Returns forced granite's launch counts."""
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN
    emit("train_decisions", arch=cfg.name, batch=b, tokens=s,
         leaves=train_decisions(cfg, b, s))
    transpose_copies(cfg, b, s)
    batch = train_batch(cfg, b, s)
    runs = {}
    for mode in TRAIN_MODES:
        mcfg = dataclasses.replace(cfg, falcon_mode=mode)
        res = train_run(mode, mcfg, batch, TRAIN_STEPS, profile=mode != "auto")
        check_covered(f"train/{mode}", res.pop("state"))
        res.pop("grads")
        if res["plan_misses"] and mode == "auto":
            raise AssertionError(f"train/{mode}: {res['plan_misses']} plan misses after warm_train")
        runs[mode] = res
        free_memory()
    gemm_loss = runs["gemm"]["losses"][0]
    for mode in ("auto", "strassen"):
        rel = abs(runs[mode]["losses"][0] - gemm_loss) / abs(gemm_loss)
        emit("train_vs_gemm", mode=mode, first_loss=runs[mode]["losses"][0],
             gemm_first_loss=gemm_loss, rel=rel, tol=TRAIN_LOSS_TOL)
        if not rel <= TRAIN_LOSS_TOL:
            raise AssertionError(f"train/{mode}: first loss {rel} from gemm's > {TRAIN_LOSS_TOL}")
    bwd = runs["strassen"]["backward_launches"]
    for k in ("group_combine", "fused_gemm_combine_h", "batched_group_combine",
              "batched_fused_gemm_combine_h"):
        if not bwd.get(k):
            raise AssertionError(f"train/strassen: no {k} launch in backward: {bwd}")
    # gradients in float32: granite cut to GRAD_LAYERS layers
    f32 = dataclasses.replace(cfg, dtype="float32", num_layers=GRAD_LAYERS)
    grad_check("granite_f32", f32, batch, GRAD_LAYERS)
    # mamba2: the SSD scan's contractions in backward (grouped, f32)
    scfg = dataclasses.replace(get_config(SSM_TRAIN_ARCH), dtype="float32")
    sbatch = train_batch(scfg, *SSM_TRAIN)
    runs_ssm = {}
    for mode in ("gemm", "strassen"):
        res = train_run(f"ssm_{mode}", dataclasses.replace(scfg, falcon_mode=mode), sbatch, 1,
                        keep_grads=True)
        check_covered(f"train/ssm_{mode}", res.pop("state"))
        runs_ssm[mode] = res
    bwd = runs_ssm["strassen"]["backward_launches"]
    if not (bwd.get("batched_group_combine") and bwd.get("batched_fused_gemm_combine_h")):
        raise AssertionError(f"train/ssm_strassen: no #2/#4 launch in backward: {bwd}")
    gemm_grads = flat(runs_ssm["gemm"]["grads"])
    errs = {k: rel_frob(g, gemm_grads[k]) for k, g in flat(runs_ssm["strassen"]["grads"]).items()}
    ulp = ulp_sensitivity(dataclasses.replace(scfg, falcon_mode="gemm"), sbatch, gemm_grads)
    emit("train_ssm_grads", arch=scfg.name, layers=scfg.num_layers, held=False,
         max_rel_frob=max(errs.values()), worst=max(errs, key=errs.get),
         gemm_one_ulp_max_rel_frob=max(ulp.values()), per_leaf=errs)
    del runs_ssm, gemm_grads
    free_memory()
    grad_check("mamba2_f32", dataclasses.replace(scfg, num_layers=GRAD_LAYERS), sbatch,
               GRAD_LAYERS)
    return runs["strassen"]["launches"]


def ulp_sensitivity(cfg, batch: dict, grads: dict) -> dict:
    """The stack's own sensitivity to rounding: each leaf's gradient in gemm
    mode with every weight moved by one float32 ulp (a random sign each),
    against ``grads`` (gemm's, unmoved), relative Frobenius."""
    params = M.init_params(cfg, 0, DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    with torch.no_grad():
        for p in tree_leaves(params):
            p.mul_(1 + 2.0 ** -23 * (2 * torch.randint(0, 2, p.shape, device=DEV,
                                                         generator=gen) - 1))
    with falcon.use(M.falcon_config_for(cfg)):
        _, _, moved = loss_and_grads(params, cfg, batch)
    out = {k: rel_frob(g, grads[k]) for k, g in flat(moved).items()}
    del params, moved
    return out


def grad_check(name: str, cfg, batch: dict, layers: int) -> None:
    """One gradient of ``cfg`` (float32, weights from seed 0) in gemm mode
    and under forced strassen: every leaf's within GRAD_TOL (relative
    Frobenius), every launch at a checked shape."""
    free_memory()
    params = M.init_params(cfg, 0, DEV)
    grads = {}
    for mode in ("gemm", "strassen"):
        mcfg = dataclasses.replace(cfg, falcon_mode=mode)
        kernels.reset_launch_counts()
        with falcon.use(M.falcon_config_for(mcfg)):
            loss, _, g = loss_and_grads(params, mcfg, batch)
        check_covered(f"train/{name}/{mode}", kernels.launch_state())
        grads[mode] = (float(loss), flat(g))
    errs = {k: rel_frob(g, grads["gemm"][1][k]) for k, g in grads["strassen"][1].items()}
    worst = max(errs, key=errs.get)
    emit("train_grad_check", name=name, arch=cfg.name, layers=layers, dtype=cfg.dtype,
         loss_gemm=grads["gemm"][0], loss_strassen=grads["strassen"][0],
         max_rel_frob=errs[worst], worst=worst, tol=GRAD_TOL, per_leaf=errs)
    if not errs[worst] <= GRAD_TOL:
        raise AssertionError(f"train/{name}: {worst}'s forced gradient {errs[worst]} from "
                             f"gemm's > {GRAD_TOL}")
    del params, grads
    free_memory()


# ---------------------------------------------------------------------------
# Multi-device training: granite_3_2b at full width and a cut depth on a
# 2 x 1 mesh (ZeRO-3, fsdp_only, int8-compressed DP) and a 1 x 2 mesh
# (tensor parallel) of two ranks sharing this card over gloo
# ---------------------------------------------------------------------------

TRAIN_MESH_LAYERS = 4           # of 40: every collective is staged through host memory
TRAIN_MESH_GRAD_LAYERS = 2      # the float32 gradient check
TRAIN_MESH_STEPS = 3            # steps 1-3 (step 0's lr is 0)
DP_MESH = {"data": 2, "model": 1}
DP_LABEL = "gloo, 2 data ranks sharing one card"
# (run, mesh, modes): each run's losses at steps 1-3 (compressed_dp's at
# step 1) within TRAIN_MESH_LOSS_TOL of one device (relative), its float32
# gradient (in TRAIN_MESH_GRAD_MODE) within TRAIN_MESH_GRAD_TOL (relative
# Frobenius, the worst leaf; compressed_dp's is printed against the exact
# mean and held to the plain compressed mean bit for bit)
TRAIN_MESH_RUNS = (("fsdp", DP_MESH, ("gemm", "strassen")),
                   ("fsdp_only", DP_MESH, ("strassen",)),
                   ("compressed_dp", DP_MESH, ("gemm",)),
                   ("tp", MESH, ("gemm", "strassen")))
TRAIN_MESH_SHAPES = {run: mesh for run, mesh, _ in TRAIN_MESH_RUNS}
TRAIN_MESH_LOSS_TOL = {"fsdp": 1e-3, "fsdp_only": 1e-3, "compressed_dp": 1e-3, "tp": 1e-2}
TRAIN_MESH_GRAD_MODE = {"fsdp": "gemm", "fsdp_only": "strassen", "compressed_dp": "gemm",
                        "tp": "strassen"}
TRAIN_MESH_GRAD_TOL = {"fsdp": 1e-4, "fsdp_only": 1e-4, "tp": 1e-4, "compressed_dp": 2e-2}
# the compressed mean against one device's gradient, elementwise, in the
# leaf's quantization steps: half a step of rounding, and one device's
# float32 sums in another order (1e-5 of the largest value is 1.3e-3 step)
COMPRESSED_STEP_TOL = 0.51
TRAIN_MESH_DIR = os.path.join(ROOT, "build", "train_mesh")
# what phase train_mesh leaves for phase serve_mesh: the 1 x 2 runs' jobs
# (they run in serve_mesh's ranks) and the one-device references
TRAIN_MESH_REFS: dict = {}


def train_mesh_config(run: str, mode: str, layers: int, dtype: str):
    """granite_3_2b at full width, ``layers`` deep, for one run: ``fsdp``
    (the published config's ``fsdp=True``: ZeRO-3 over "data", the
    launcher's default), ``fsdp_only`` (that style and the
    ``shard_map_local`` backend), ``compressed_dp`` (parameters
    replicated) and ``tp`` (on a 1 x 2 mesh the data axis is 1)."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers, dtype=dtype,
                              falcon_mode=mode)
    if run == "fsdp_only":
        cfg = dataclasses.replace(cfg, parallel_style="fsdp_only",
                                  falcon_backend="shard_map_local")
    return cfg


def train_mesh_kernel_cases() -> list[tuple[str, str, torch.dtype, dict, object]]:
    """:func:`launch_kernel_cases` of every call of #1-#4 one rank of phase
    train_mesh makes (:func:`train_launches` at the shapes it contracts):
    each run's forced bf16 steps and its float32 gradient."""
    b, s = TRAIN
    keys: dict[str, set] = {}
    for run, mesh, modes in TRAIN_MESH_RUNS:
        tag = f"{TRAIN_ARCH}@{'tp_train' if run == 'tp' else 'fsdp'}"
        for mode in modes:
            cfg = train_mesh_config(run, mode, TRAIN_MESH_LAYERS, "bfloat16")
            keys.setdefault(tag, set()).update(train_launches(cfg, mode, b, s, mesh))
        mode = TRAIN_MESH_GRAD_MODE[run]
        cfg = train_mesh_config(run, mode, TRAIN_MESH_GRAD_LAYERS, "float32")
        keys.setdefault(tag, set()).update(train_launches(cfg, mode, b, s, mesh))
    return launch_kernel_cases(keys)


def float_numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree) if t.is_floating_point())


def train_mesh_job(mesh, run: str, mode: str) -> dict:
    """One run of phase train_mesh on this rank: granite (bf16, full width,
    TRAIN_MESH_LAYERS deep, weights from seed 0 placed by ``make_rules(mesh,
    fsdp=cfg.fsdp, style=cfg.parallel_style)``; replicated for
    ``compressed_dp``), its rows of the global TRAIN batch
    (``SyntheticLMData`` over the batch axes), ``warm_train(mesh_shape=)``,
    then TRAIN_MESH_STEPS AdamW steps through make_train_step (or
    make_compressed_dp_train_step) in a TrainLoop. Returned: losses, ms a
    step, tokens/s of the global batch, peak bytes, m/v bytes (asserted equal
    to the reckoning from this rank's shards), launches in all and in the
    cores' backward, the collectives by operation (``/bwd``: in backward),
    plan misses after the warm pass, the shard_map_local hook's decisions,
    and each step's gradients checked finite and nonzero. Counts are reset
    just before the loop."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_mesh_config(run, mode, TRAIN_MESH_LAYERS, "bfloat16")
    b, s = TRAIN
    free_memory()
    params = M.init_params(cfg, 0, DEV)
    whole = float_numel(params)
    placement = rules = None
    if run != "compressed_dp":
        rules = SH.make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)
        placement = SH.param_sharding(params, mesh, rules, cfg)
        params = SH.shard_params(params, cfg, mesh, rules)
        free_memory()
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(params, opt_cfg)
    local = float_numel(params)
    mv = sum(t.numel() * t.element_size() for t in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    if mv != 2 * 4 * local:
        raise AssertionError(f"train_mesh/{run}/{mode}: m and v hold {mv} B, the rank's shards "
                             f"({local} float elements) reckon {2 * 4 * local}")
    spec = ("data",) if run == "compressed_dp" else SH.loss_axes(cfg.parallel_style)
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                       seed=0), device=DEV, mesh=mesh, batch_spec=spec).batch(0)
    with falcon.use(M.falcon_config_for(cfg)):
        n_plans = warm_train(cfg, b, s, mesh_shape=mesh.shape)
        misses = plan_cache.stats().misses
        if run == "compressed_dp":
            step = make_compressed_dp_train_step(cfg, opt_cfg, mesh,
                                                 total_steps=TRAIN_MESH_STEPS + 1, warmup=1)
        else:
            step = make_train_step(cfg, opt_cfg, total_steps=TRAIN_MESH_STEPS + 1, warmup=1,
                                   mesh=mesh, placement=placement)
        loop = TrainLoop(TrainLoopConfig(total_steps=TRAIN_MESH_STEPS + 1,
                                         checkpoint_every=10 ** 9, checkpoint_dir=TRAIN_CKPT,
                                         log_every=10 ** 9),
                         step, _SameBatch(batch), params, state, mesh=mesh,
                         placement=placement, rules=rules, model_cfg=cfg)
        SHARD_MAP_LOCAL.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        mesh.stats.reset()
        with captured_grads(False) as grads, backward_launches() as bwd:
            out = loop.run(start_step=1)
        launches = kernels.launch_state()
        peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    ms = [h["time"] * 1e3 for h in hist]
    steady = statistics.mean(ms[1:])
    bad = [(i, k) for i, st in enumerate(grads["stats"])
           for k, (finite, norm) in st.items() if not finite or norm <= 0]
    res = {"run": run, "mode": mode, "rank": mesh.rank, "losses": [h["loss"] for h in hist],
           "ms": ms, "ms_steady": steady, "tok_s": b * s / (steady / 1e3), "peak_bytes": peak,
           "mv_bytes": mv, "float_elements": {"rank": local, "whole": whole},
           "warm_plans": n_plans, "plan_misses": plan_cache.stats().misses - misses,
           "launches": {k: v for k, v in launches.items() if isinstance(k, str) and v},
           "backward_launches": {k: v for k, v in bwd.items() if isinstance(k, str) and v},
           "collectives": mesh.stats.as_dict(), "hook": dict(SHARD_MAP_LOCAL),
           "update_ms": grads["update_ms"], "bad_grads": bad[:8], "state": dict(launches)}
    del loop, params, state, grads
    free_memory()
    return res


def compressed_mean_plain(parts: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The reference's int``bits``-compressed mean of one leaf, written out
    rank by rank (``parts[r]``: rank r's local gradient), apart from the
    port's bucketed ``compressed_psum_mean``: the scale is the largest
    magnitude over the ranks (at least 1e-20), each rank's gradient is
    rounded half to even to int8 levels of it and clipped, the levels are
    summed in int32 and dequantized over the rank count."""
    levels = float(2 ** (bits - 1) - 1)
    n = parts.shape[0]
    scale = parts[0].float().abs().max()
    for r in range(1, n):
        scale = torch.maximum(scale, parts[r].float().abs().max())
    scale = torch.clamp(scale, min=1e-20)
    total = torch.zeros(parts.shape[1:], dtype=torch.int32, device=parts.device)
    for r in range(n):
        q = torch.clamp(torch.round(parts[r].float() / scale * levels), -levels, levels)
        total += q.to(torch.int8).to(torch.int32)
    return (total.float() * (scale / levels) / n).to(parts.dtype)


def compressed_step_grads(mesh, params, cfg, batch) -> dict:
    """One step (step 1) of make_compressed_dp_train_step on this rank,
    with each rank's local gradient (what ``loss_and_grads`` returns inside
    the step) and the gradient the step hands AdamW captured. Returned: the
    step's loss, the applied gradient, every rank's local gradient stacked
    (gathered to every rank), the step's collective calls, and a digest of
    the updated parameters (equal on every rank: they are replicas)."""
    local, orig = {}, train_steps.loss_and_grads

    def spy(*a, **kw):
        out = orig(*a, **kw)
        local.update(flat(out[2]))
        return out

    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(params, opt_cfg)
    step = make_compressed_dp_train_step(cfg, opt_cfg, mesh, total_steps=2, warmup=1)
    mesh.stats.reset()
    train_steps.loss_and_grads = spy
    try:
        with captured_grads(True) as seen:
            params, state, metrics = step(params, state, batch, 1)
    finally:
        train_steps.loss_and_grads = orig
    calls = dict(mesh.stats.calls)
    parts = {k: all_gather(v.unsqueeze(0), mesh, ("data",), dim=0) for k, v in local.items()}
    digest = [float(p.detach().double().sum()) for p in tree_leaves(params)
              if p.is_floating_point()]
    return {"loss": float(metrics["loss"]), "applied": flat(seen["first"]), "parts": parts,
            "calls": calls, "digest": digest}


def train_mesh_grad_job(mesh, run: str) -> dict:
    """The float32 gradient of one run on this rank (granite cut to
    TRAIN_MESH_GRAD_LAYERS, full width, TF32 off, in TRAIN_MESH_GRAD_MODE):
    the mesh's gathered whole, held on rank 0 leaf by leaf against the
    one-device gradient phase train_mesh saved (relative Frobenius). For
    ``compressed_dp``, the gradient the compressed step applied
    (:func:`compressed_step_grads`), also held on rank 0 to
    :func:`compressed_mean_plain` of the ranks' local gradients (bit for
    bit) and to their exact mean (relative Frobenius, nonzero)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = TRAIN_MESH_GRAD_MODE[run]
    cfg = train_mesh_config(run, mode, TRAIN_MESH_GRAD_LAYERS, "float32")
    b, s = TRAIN
    free_memory()
    params = M.init_params(cfg, 0, DEV)
    placement = None
    if run != "compressed_dp":
        rules = SH.make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)
        placement = SH.param_sharding(params, mesh, rules, cfg)
        params = SH.shard_params(params, cfg, mesh, rules)
    spec = ("data",) if run == "compressed_dp" else SH.loss_axes(cfg.parallel_style)
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                       seed=0), device=DEV, mesh=mesh, batch_spec=spec).batch(0)
    kernels.reset_launch_counts()
    steps, comp = {}, {}
    with falcon.use(M.falcon_config_for(cfg)):
        if run == "compressed_dp":
            cs = compressed_step_grads(mesh, params, cfg, batch)
            loss, g = cs["loss"], cs["applied"]
            comp = {"calls": cs["calls"], "digest": cs["digest"], "plain_mismatch": {}}
            if mesh.rank == 0:
                sq_diff = sq_exact = 0.0
                for k, parts in cs["parts"].items():
                    plain = compressed_mean_plain(parts)
                    if not torch.equal(g[k], plain):
                        comp["plain_mismatch"][k] = float((g[k] - plain).abs().max())
                    exact = parts.sum(0) / parts.shape[0]
                    sq_diff += float((g[k] - exact).double().square().sum())
                    sq_exact += float(exact.double().square().sum())
                    # the leaf's quantization step, scale / 127
                    steps[k] = float(parts.abs().max()) / 127.0
                comp["vs_exact"] = math.sqrt(sq_diff / sq_exact)
            del cs
        else:
            loss, _, g = loss_and_grads(params, cfg, batch, mesh=mesh, placement=placement)
            loss = loss.item()
            g = gather_state(g, placement, mesh)
    state = dict(kernels.launch_state())
    errs, whole, in_steps = {}, None, {}
    if mesh.rank == 0:
        want = torch.load(os.path.join(TRAIN_MESH_DIR, f"grads_{mode}.pt"))
        sq_diff = sq_want = 0.0
        for k, v in flat(g).items():
            got, w = v.to(DEV).float(), want[k].to(DEV).float()
            errs[k] = rel_frob(got, w)
            if k in steps:       # the largest error, in quantization steps
                in_steps[k] = float((got - w).abs().max()) / steps[k]
            sq_diff += float((got - w).square().sum())
            sq_want += float(w.square().sum())
        whole = math.sqrt(sq_diff / sq_want)
    del params, g
    free_memory()
    return {"run": run, "mode": mode, "loss": loss, "errs": errs, "whole": whole,
            "err_in_steps": in_steps, "compressed": comp, "state": state}



def train_mesh_jobs(mesh, jobs: list) -> list:
    """Phase train_mesh's jobs on this rank: ("train", run, mode), ("grad",
    run) and ("serve", refs), the data axis's serving runs
    (:func:`serve_runs`)."""
    run = {"train": train_mesh_job, "grad": train_mesh_grad_job, "serve": serve_runs}
    return [run[j[0]](mesh, *j[1:]) for j in jobs]


def one_device_train(cfg, batch: dict) -> dict:
    """``cfg`` on one device (weights from seed 0) for TRAIN_MESH_STEPS
    steps through make_train_step in a TrainLoop: the losses and ms a step."""
    free_memory()
    params = M.init_params(cfg, 0, DEV)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(params, opt_cfg)
    b, s = batch["tokens"].shape[:2]
    with falcon.use(M.falcon_config_for(cfg)):
        warm_train(cfg, b, s)
        step = make_train_step(cfg, opt_cfg, total_steps=TRAIN_MESH_STEPS + 1, warmup=1)
        loop = TrainLoop(TrainLoopConfig(total_steps=TRAIN_MESH_STEPS + 1,
                                         checkpoint_every=10 ** 9, checkpoint_dir=TRAIN_CKPT,
                                         log_every=10 ** 9),
                         step, _SameBatch(batch), params, state)
        torch.cuda.reset_peak_memory_stats()
        out = loop.run(start_step=1)
    ms = [h["time"] * 1e3 for h in out["history"]]
    res = {"losses": [h["loss"] for h in out["history"]], "ms": ms,
           "ms_steady": statistics.mean(ms[1:]), "peak_bytes": torch.cuda.max_memory_allocated()}
    del loop, params, state
    free_memory()
    return res


def check_train_mesh(results: list, refs: dict) -> dict:
    """Hold each rank's runs of phase train_mesh to one device: every
    launch at a checked shape, no plan missed after the warm pass, every
    gradient finite and nonzero, the ranks' losses equal, the losses of
    steps 1-3 (compressed_dp's of step 1) within TRAIN_MESH_LOSS_TOL,
    forced strassen's forward and backward through #1-#4, the float32
    gradient within TRAIN_MESH_GRAD_TOL (compressed_dp's: the plain
    compressed mean bit for bit, not the exact mean). One
    ``train_mesh`` line per run and mode, one ``train_mesh_grads`` line per
    run. Returns rank 0's launch counts of each forced run by run."""
    by_job: dict = {}
    for rank_res in results:
        for r in rank_res:
            by_job.setdefault((r["run"], r["mode"], "errs" in r), []).append(r)
    counts = {}
    for (run, mode, grad), rs in sorted(by_job.items()):
        for i, r in enumerate(rs):
            check_covered(f"train_mesh/{run}/{mode}{'/grad' if grad else ''}/rank{i}",
                          collections.Counter(r["state"]))
        if grad:
            errs = rs[0]["errs"]
            worst = max(errs, key=errs.get)
            tol = TRAIN_MESH_GRAD_TOL[run]
            steps = rs[0]["err_in_steps"]
            comp = rs[0]["compressed"]
            emit("train_mesh_grads", run=run, mode=mode, layers=TRAIN_MESH_GRAD_LAYERS,
                 dtype="float32", mesh=TRAIN_MESH_SHAPES[run], loss_by_rank=[r["loss"] for r in rs],
                 one_device_loss=refs["grad_loss"][mode], whole_rel_frob=rs[0]["whole"],
                 max_rel_frob=errs[worst], worst=worst, tol=tol, per_leaf=errs,
                 max_err_in_quant_steps=steps or None,
                 quant_step_tol=COMPRESSED_STEP_TOL if steps else None,
                 step_collective_calls=comp.get("calls"),
                 plain_mismatch=comp.get("plain_mismatch"),
                 vs_exact_rel_frob=comp.get("vs_exact"),
                 reference_bar=("met" if comp["vs_exact"] <= tol else "not met") if comp else None)
            if run == "compressed_dp":
                # the step's applied gradient is the reference's compressed
                # mean of the ranks' local gradients, bit for bit, through
                # one max all-reduce (every leaf's scale); it is not the
                # exact mean, and each rank rounds to the nearest of 255
                # levels of the leaf's scale, so the mean is off by at most
                # half a step (scale / 127) anywhere. Its distance from the
                # exact mean is printed beside the reference's 2e-2 bar,
                # which it does not meet on these heavy-tailed gradients
                # (PERF.md, PR 24)
                if comp["plain_mismatch"] or len(steps) != len(errs):
                    raise AssertionError(f"train_mesh/compressed_dp: the step's gradient is not "
                                         f"the plain compressed mean: {comp['plain_mismatch']}")
                if not comp["vs_exact"] > 0:
                    raise AssertionError("train_mesh/compressed_dp: the step's gradient is the "
                                         "exact mean: nothing was compressed")
                if any(r["compressed"]["calls"].get("all_reduce_max") != 1 for r in rs):
                    raise AssertionError(f"train_mesh/compressed_dp: the step made "
                                         f"{[r['compressed']['calls'] for r in rs]} collectives, "
                                         f"not one max all-reduce")
                if any(r["compressed"]["digest"] != comp["digest"] for r in rs):
                    raise AssertionError("train_mesh/compressed_dp: the ranks' updated "
                                         "parameters differ")
                bad = {k: e for k, e in steps.items() if not e <= COMPRESSED_STEP_TOL}
                if bad:
                    raise AssertionError(f"train_mesh/compressed_dp: the compressed mean is "
                                         f"off by more than {COMPRESSED_STEP_TOL} of a "
                                         f"quantization step: {bad}")
            elif not errs[worst] <= tol:
                raise AssertionError(f"train_mesh/{run}: {worst}'s float32 gradient "
                                     f"{errs[worst]} from one device's > {tol}")
            continue
        one = refs["one_device"][mode]
        r0 = rs[0]
        rels = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
        rel = rels[0]
        tol = TRAIN_MESH_LOSS_TOL[run]
        emit("train_mesh", run=run, mode=mode, arch=TRAIN_ARCH, layers=TRAIN_MESH_LAYERS,
             dtype="bfloat16", mesh=TRAIN_MESH_SHAPES[run], label=MESH_LABEL, batch=TRAIN[0],
             tokens=TRAIN[1], losses_by_rank=[r["losses"] for r in rs],
             one_device=one, first_loss_rel=rel, loss_rel_by_step=rels, tol=tol,
             ms_by_rank=[r["ms"] for r in rs], ms_steady_by_rank=[r["ms_steady"] for r in rs],
             tok_s_by_rank=[r["tok_s"] for r in rs],
             peak_bytes_by_rank=[r["peak_bytes"] for r in rs],
             mv_bytes_by_rank=[r["mv_bytes"] for r in rs],
             float_elements_by_rank=[r["float_elements"] for r in rs],
             collectives_by_rank=[r["collectives"] for r in rs],
             launches_by_rank=[r["launches"] for r in rs],
             backward_launches_by_rank=[r["backward_launches"] for r in rs],
             plan_misses_by_rank=[r["plan_misses"] for r in rs],
             warm_plans=r0["warm_plans"], hook_by_rank=[r["hook"] for r in rs],
             update_ms_by_rank=[r["update_ms"] for r in rs])
        if any(r["bad_grads"] for r in rs) or not all(math.isfinite(x) for r in rs
                                                      for x in r["losses"]):
            raise AssertionError(f"train_mesh/{run}/{mode}: a non-finite loss or a zero or "
                                 f"non-finite gradient: {[r['bad_grads'] for r in rs]}")
        if any(r["losses"] != r0["losses"] for r in rs):
            raise AssertionError(f"train_mesh/{run}/{mode}: the ranks' losses differ")
        if any(r["plan_misses"] for r in rs):
            raise AssertionError(f"train_mesh/{run}/{mode}: plan misses after warm_train "
                                 f"{[r['plan_misses'] for r in rs]}")
        if not rel <= tol:
            raise AssertionError(f"train_mesh/{run}/{mode}: step-1 loss {rel} from one "
                                 f"device's > {tol}")
        # after step 1 the exact styles' updates (sharded AdamW, the whole
        # tree's clip) are one device's; the compressed step's are not (its
        # gradient is quantized), so only its first loss is held here and
        # its gradient by its grad job
        if run != "compressed_dp" and not (len(rels) == TRAIN_MESH_STEPS
                                           and max(rels) <= tol):
            raise AssertionError(f"train_mesh/{run}/{mode}: losses {r0['losses']} from one "
                                 f"device's {one['losses']} > {tol} relative")
        if run == "compressed_dp" and any(
                r["collectives"]["collective_calls"].get("all_reduce_max") != len(r["losses"])
                for r in rs):
            raise AssertionError(f"train_mesh/compressed_dp/{mode}: not one max all-reduce "
                                 f"a step: {[r['collectives']['collective_calls'] for r in rs]}")
        if run == "fsdp_only" and any(not r["hook"].get("taken") for r in rs):
            raise AssertionError(f"train_mesh/fsdp_only: the shard_map_local hook took no "
                                 f"contraction: {[r['hook'] for r in rs]}")
        if mode == "strassen":
            for r in rs:
                for k in ENGINE_FP_KERNELS:
                    if not r["launches"].get(k) or not r["backward_launches"].get(k):
                        raise AssertionError(f"train_mesh/{run}/strassen: rank {r['rank']} ran "
                                             f"no {k} forward and backward: {r['launches']}, "
                                             f"{r['backward_launches']}")
            counts[run] = r0["launches"]
    return counts


def phase_train_mesh() -> dict:
    """granite_3_2b at full width, TRAIN_MESH_LAYERS deep (bf16, the TRAIN
    batch of 4 x 512, weights from seed 0, steps 1-3) trained by two ranks
    spawned on this card over gloo: on 2 x 1, ZeRO-3 (the launcher's
    default rules, gemm and forced strassen), ``fsdp_only`` with the
    ``shard_map_local`` backend (forced) and the int8-compressed DP step
    (gemm); on 1 x 2, tensor parallel (gemm and forced; those run in phase
    serve_mesh's ranks, which this phase hands its jobs to). Each is held
    to one device on the same weights and batch (:func:`check_train_mesh`),
    and its float32 gradient, cut to TRAIN_MESH_GRAD_LAYERS, to one
    device's. The same 2 x 1 ranks then serve granite over the data axis
    (:func:`serve_runs`: the one-shot at published depth in MESH_MODES, at
    2 layers in float32, the 8-layer engine), held to one device by
    :func:`check_serve_runs` (``serve_data`` lines). Returns rank 0's
    launch counts of the forced fsdp run."""
    os.makedirs(TRAIN_MESH_DIR, exist_ok=True)
    b, s = TRAIN
    base = get_config(TRAIN_ARCH)
    batch = train_batch(base, b, s)
    one = {mode: one_device_train(dataclasses.replace(base, num_layers=TRAIN_MESH_LAYERS,
                                                      falcon_mode=mode), batch)
           for mode in ("gemm", "strassen")}
    grad_loss = {}
    for mode in ("gemm", "strassen"):
        cfg = dataclasses.replace(base, num_layers=TRAIN_MESH_GRAD_LAYERS, dtype="float32",
                                  falcon_mode=mode)
        params = M.init_params(cfg, 0, DEV)
        with falcon.use(M.falcon_config_for(cfg)):
            loss, _, g = loss_and_grads(params, cfg, batch)
        grad_loss[mode] = loss.item()
        torch.save({k: v.cpu() for k, v in flat(g).items()},
                   os.path.join(TRAIN_MESH_DIR, f"grads_{mode}.pt"))
        del params, g
        free_memory()
    TRAIN_MESH_REFS.update(one_device=one, grad_loss=grad_loss, jobs=[
        *(("train", "tp", mode) for mode in ("gemm", "strassen")), ("grad", "tp")])
    jobs = [("train", run, mode) for run, mesh, modes in TRAIN_MESH_RUNS if mesh == DP_MESH
            for mode in modes]
    jobs += [("grad", run) for run, mesh, _ in TRAIN_MESH_RUNS if mesh == DP_MESH]
    # serving's data axis rides in this 2 x 1 spawn, after the training jobs
    one = mesh_singles()
    jobs.append(("serve", {"oneshot": {mode: one["oneshot"][mode]["tokens"]
                                       for mode in MESH_MODES}}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = PM.run_ranks(train_mesh_jobs, DP_MESH, jobs, backend="gloo", device=DEV,
                         workdir=TRAIN_MESH_DIR, timeout=600)
    emit("train_mesh_spawn", mesh=DP_MESH, jobs=[list(j[:1] if j[0] == "serve" else j)
                                                  for j in jobs],
         seconds=time.perf_counter() - t0)
    check_serve_runs("serve_data", [r.pop() for r in ranks], DP_MESH, DP_LABEL)
    return check_train_mesh(ranks, TRAIN_MESH_REFS)["fsdp"]


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


# ---------------------------------------------------------------------------
# The static tools and the host: calibrate_cpu, falcon-check, the dry run
# ---------------------------------------------------------------------------

DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
DRYRUN_CELLS = (("granite_3_2b", "train_4k", "single"), ("kimi_k2_1t", "decode_32k", "multi"))


def phase_calibrate_cpu() -> None:
    """``hardware.calibrate_cpu()`` on this machine's host CPU: the host's
    (FLOPS_x, FLOPS_+, beta) from torch.matmul at 1024^3, Strassen's Combine
    A through the generated "torch" backend and the 7-batched product."""
    from repro_torch.core import hardware
    t = time.perf_counter()
    p = hardware.calibrate_cpu()
    emit("calibrate_cpu", name=p.name, flops_mul=p.flops_mul, flops_add=p.flops_add,
         beta=p.beta, lcma_gemm_efficiency=p.lcma_gemm_efficiency,
         threads=torch.get_num_threads(), seconds=time.perf_counter() - t)
    if not all(math.isfinite(v) and v > 0 for v in (p.flops_mul, p.flops_add, p.beta)):
        raise AssertionError(f"calibrate_cpu: {p}")


def phase_check() -> None:
    """``repro_torch.tools.check --all --hardware h100_sxm`` in this
    process: every scheme's Brent equations and bounds, the plan lint of
    every candidate and every arch's contractions against the H100's
    budgets, the codegen lint, a round-tripped cache's audit. It must
    report 0 errors."""
    from repro_torch.tools import check as check_cli
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = check_cli.main(["--all", "--hardware", "h100_sxm"])
    last = buf.getvalue().strip().splitlines()[-1]
    n = [int(x) for x in re.findall(r"(\d+) ", last)]
    emit("check", argv=["--all", "--hardware", "h100_sxm"], exit=rc, findings=n[0],
         errors=n[1], warnings=n[2], summary=last, seconds=time.perf_counter() - t)
    if rc != 0 or n[1] != 0:
        raise AssertionError(f"check: exit {rc}: {buf.getvalue()[-3000:]}")


def start_dryruns() -> list:
    """``python -m repro_torch.launch.dryrun`` of each DRYRUN_CELLS cell, one
    process each on the host (no card visible to it), started at once, its
    output in ``<cell>.log`` beside its record: (cell, process)."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for cell in DRYRUN_CELLS:
        with open(os.path.join(DRYRUN_DIR, "__".join(cell) + ".log"), "w") as log:
            procs.append((cell, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
                 "--shape", cell[1], "--mesh", cell[2], "--out-dir", DRYRUN_DIR],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def phase_dryrun(procs: list) -> None:
    """Each dry-run cell's record: rank 0 of the production mesh traced on
    the meta device over the fake backend; its argument bytes, traced FLOPs
    and bytes, collective bytes and seconds. A cell that is not ``ok``
    fails."""
    for (arch, shape, mesh), proc in procs:
        proc.wait(timeout=300)
        path = os.path.join(DRYRUN_DIR, f"{arch}__{shape}__{mesh}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(DRYRUN_DIR, f"{arch}__{shape}__{mesh}.log")) as f:
                out = f.read()
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: exit {proc.returncode}\n"
                                 f"{out[-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: {rec.get('error')}")
        emit("dryrun", arch=arch, shape=shape, mesh=mesh, chips=rec["roofline"]["chips"],
             n_params=rec["n_params"], n_active_params=rec["n_active_params"],
             argument_bytes=rec["argument_bytes"], argument_bytes_by=rec["argument_bytes_by"],
             traced_flops=rec["traced_flops"], traced_bytes=rec["traced_bytes"],
             collective_bytes=rec["collective_bytes"],
             collective_calls=rec["collective_calls"],
             analytic={k: rec["analytic"][k] for k in ("flops_dev", "hbm_bytes_dev",
                                                       "coll_bytes_dev", "bottleneck",
                                                       "step_time")},
             seconds=rec["seconds"])


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
    # the dry runs need no card: two processes on the host, started now,
    # waited for before the first timed phase and read at the end (stopped
    # on the way out, whatever happens)
    dry = start_dryruns()
    try:
        run_phases(dry, t0)
    finally:
        for _, proc in dry:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def run_phases(dry: list, t0: float) -> None:
    """Every phase in order, then the ``total`` and ``kernels`` lines."""
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
    # the dry runs overlap the build and the checks above; no timed phase
    # runs beside them
    t = time.perf_counter()
    for _, proc in dry:
        proc.wait(timeout=300)
    dry_done = {"dryruns_done_at": time.perf_counter() - t0,
                "dryruns_waited": time.perf_counter() - t}
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
    run(phase_moe_layer)
    moe_counts = run(phase_serve_moe)
    run(phase_serve_engine_moe)
    run(phase_ssd_layer)
    ssd_counts = run(phase_serve_ssm)
    run(phase_serve_engine_ssm)
    fe_counts = run(phase_serve_frontends)
    run(phase_checkpoint)
    train_counts = run(phase_train)
    fsdp_counts = run(phase_train_mesh)
    mesh_counts = run(phase_serve_mesh)
    mesh_counts.update({f"{k}@fsdp": v for k, v in fsdp_counts.items()})
    run(phase_calibrate_cpu)
    run(phase_check)
    run(phase_dryrun, dry)
    emit("total", seconds=time.perf_counter() - t0, phases=phases, **dry_done)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": counts[k], "max_abs_err": times[k]["max_abs_err"],
         "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
         "bound_ms": times[k]["bound_ms"], "bound_by": times[k]["bound_by"],
         "library_ms": times[k]["library_ms"]} for k in SOURCES] + [
        # the expert FFN's calls (dbrx, forced strassen), launches from serve_moe
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": moe_counts[k.split("@")[0]],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for k in ("batched_group_combine@moe_b", "batched_group_combine@moe_a",
                  "batched_fused_gemm_combine_h@moe", "batched_fused_gemm_combine_h@moe_decode")] + [
        # the SSD scan's contractions (mamba2, forced strassen, f32), launches
        # from serve_ssm
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": ssd_counts[k.split("@")[0]],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for k in ("batched_group_combine@ssd", "batched_fused_gemm_combine_h@ssd")] + [
        # musicgen's codebook heads at decode (forced strassen, and --quant),
        # launches from serve_frontends
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": fe_counts[k.split("@")[0]],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for k in ("group_combine@codebook_head", "fused_gemm_combine_h@codebook_head",
                  "group_combine_quant@codebook_head",
                  "fused_gemm_combine_h_quant@codebook_head")] + [
        # granite's backward (forced strassen), launches from phase train
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": train_counts[k.split("@")[0]],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for k in ("group_combine@train_dA", "fused_gemm_combine_h@train_dA",
                  "group_combine@train_dB", "fused_gemm_combine_h@train_dB",
                  "batched_group_combine@train_attn",
                  "batched_fused_gemm_combine_h@train_attn")] + [
        # one rank of the 1 x 2 mesh (granite tensor-parallel, dbrx's layer
        # expert-parallel; forced strassen), launches from serve_mesh's rank 0
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": mesh_counts[k],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for k in ("group_combine@tp", "batched_group_combine@tp", "fused_gemm_combine_h@tp",
                  "batched_fused_gemm_combine_h@tp", "batched_group_combine@ep",
                  "batched_fused_gemm_combine_h@ep")] + [
        # one rank of phase train_mesh's meshes (forced strassen): 2 x 1
        # ZeRO-3 (``@fsdp``) and 1 x 2 tensor parallel (``@tp_train``),
        # launches from rank 0 of those runs
        {"name": k, "route": "cuda", "source": SOURCES[k.split("@")[0]],
         "replaces": REPLACES[k.split("@")[0]], "launches": mesh_counts[k],
         "max_abs_err": times[k]["max_abs_err"], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"]}
        for tag in ("@fsdp", "@tp_train")
        for k in (f"group_combine{tag}", f"batched_group_combine{tag}",
                  f"fused_gemm_combine_h{tag}", f"batched_fused_gemm_combine_h{tag}")]}))


if __name__ == "__main__":
    main()
