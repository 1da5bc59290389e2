"""Drive the PyTorch/CUDA port of FalconGEMM on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each: device, build (nvcc for sm_90a from
src/repro_torch/csrc), every kernel entry point against its plain PyTorch
version (six schemes x f32/bf16 x ragged shapes and every shape the served
model gives the kernel), the four ops
pipelines against torch.matmul at granite shapes, kernel times, model parity
(2 layers at full width, f32, strassen vs gemm), serving full granite_3_2b
(40 layers, bf16, forced strassen, 4 requests x 16 tokens) with every
kernel's launch count, and what auto mode decides on the h100_sxm profile.
Any failure raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is missing. Needs a CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.api as falcon  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.lcma import LCMA  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch.serve import run_oneshot  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DEV = "cuda"
# Kernel vs plain version, error normalized by max(1, max|plain|). f32: the
# same f32 arithmetic in another summation order. bf16: both round one f32
# value once, so they differ by at most one bf16 ulp (2**-7 relative).
TOL = {torch.float32: {"combine": 1e-5, "fused": 1e-4},
       torch.bfloat16: {"combine": 1e-2, "fused": 1e-2}}
OPS_TOL = 1e-4          # f32 LCMA pipeline vs torch.matmul, normalized
PARITY_TOL = 1e-3       # 2-layer f32 prefill logits, strassen vs gemm, normalized

SOURCES = {"group_combine": "src/repro_torch/csrc/group_combine.cu",
           "batched_group_combine": "src/repro_torch/csrc/group_combine.cu",
           "fused_gemm_combine_h": "src/repro_torch/csrc/fused_gemm.cu",
           "batched_fused_gemm_combine_h": "src/repro_torch/csrc/fused_gemm.cu"}
REPLACES = {"group_combine": "src/repro/kernels/group_combine.py:47",
            "batched_group_combine": "src/repro/kernels/group_combine.py:111",
            "fused_gemm_combine_h": "src/repro/kernels/fused_gemm.py:71",
            "batched_fused_gemm_combine_h": "src/repro/kernels/fused_gemm.py:147"}


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


def fused_case(l, dtype, X, Y, Z, gen, groups=None, shared=False):
    lead = () if groups is None else (groups,)
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


def kernel_cases(l, dtype, gen):
    """Generators of (kernel call, plain call) per entry point: ragged shapes,
    then every shape the main path gives the kernel under scheme ``l``. Lazy,
    so only one case's tensors live at a time."""
    g = lambda M_, K, N: (cdiv(M_, l.m), cdiv(K, l.k), cdiv(N, l.n))  # noqa: E731
    weights = sorted({(K, N) for _, K, N in PROJ})
    return {
        "group_combine": itertools.chain(
            [combine_case(l, dtype, (37 * l.m, 53 * l.k), "U", gen, False),
             combine_case(l, dtype, (53 * l.k, 29 * l.n), "V", gen, False)],
            (combine_case(l, dtype, (M_, K), "U", gen, False)
             for M_, K in sorted({(M_, K) for M_, K, _ in PROJ})),
            # Combine B: offline for the projections, each step for the LM head
            (combine_case(l, dtype, kn, "V", gen, False) for kn in weights)),
        "batched_group_combine": itertools.chain(
            [combine_case(l, dtype, (19 * l.m, 23 * l.k), "U", gen, True)],
            (combine_case(l, dtype, (M_, K), "U", gen, True) for M_, K, _ in ATTN),
            (combine_case(l, dtype, (K, N), "V", gen, True) for _, K, N in ATTN[:2])),
        "fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 37, 53, 45, gen)],
            (fused_case(l, dtype, *g(*mkn), gen) for mkn in PROJ)),
        "batched_fused_gemm_combine_h": itertools.chain(
            [fused_case(l, dtype, 19, 23, 21, gen, groups=3),
             fused_case(l, dtype, 19, 23, 21, gen, groups=3, shared=True),
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
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Times at the main path's shapes
# ---------------------------------------------------------------------------

def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / H100_SXM.beta
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_times() -> dict:
    """Each kernel at the largest call the served model makes of it (bf16,
    forced strassen): the tied LM head's runtime Combine B, the Combine A of
    the attention scores at prefill, the mlp_up product at prefill and the
    attention scores product at prefill."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    l = alg.get("strassen")
    bf = torch.bfloat16
    it = 2
    fx = H100_SXM.flops_for("bfloat16")
    fa = H100_SXM.flops_for("float32")         # combines run on the CUDA cores
    out = {}

    def record(name, kfn, pfn, flops, nbytes, peak, logical):
        got = kfn()
        torch.cuda.synchronize()
        a, e = err(got, pfn())
        tol = TOL[bf]["fused" if "fused" in name else "combine"]
        if not e <= tol:
            raise AssertionError(f"time/{name}: error {e} > {tol}")
        ms, plain = time_ms(kfn), time_ms(pfn)
        Mq, Kq, Nq, G = logical
        xa = randn(G, Mq, Kq, dtype=bf, gen=gen) if G > 1 else randn(Mq, Kq, dtype=bf, gen=gen)
        xb = randn(G, Kq, Nq, dtype=bf, gen=gen) if G > 1 else randn(Kq, Nq, dtype=bf, gen=gen)
        matmul_ms = time_ms(lambda: torch.matmul(xa, xb))
        bms, by = bound_ms(flops, nbytes, peak)
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "library_ms": matmul_ms if "fused" in name else None,
                     "matmul_ms": matmul_ms, "max_abs_err": a, "err": e, "tol": tol,
                     "logical_mkn": [Mq, Kq, Nq], "groups": G}
        emit("time", kernel=name, **out[name])

    # LM head Combine B: embed.T (2048, 49408) -> (7, 1024, 24704)
    x = randn(2048, 49408, dtype=bf, gen=gen)
    X, Y = 1024, 24704
    record("group_combine", lambda: kernels.group_combine(x, l.V),
           lambda: ref.group_combine_ref(ref.split_blocks(x, 2, 2), l.V),
           2.0 * l.nnz_v * X * Y, (4 + l.R) * X * Y * it, fa, (256, 2048, 49408, 1))
    # attention scores Combine A at prefill: q (B*H=128, 64, 64)
    x3 = randn(128, 64, 64, dtype=bf, gen=gen)
    X, Y = 32, 32
    record("batched_group_combine", lambda: kernels.batched_group_combine(x3, l.U),
           lambda: ref.group_combine_ref(ref.split_blocks(x3, 2, 2), l.U),
           128 * 2.0 * l.nnz_u * X * Y, 128 * (4 + l.R) * X * Y * it, fa, (64, 64, 80, 128))
    # mlp_up at prefill: (256, 2048) @ (2048, 8192)
    X, Y, Z = 128, 1024, 4096
    at = randn(l.R, X, Y, dtype=bf, gen=gen)
    bt = randn(l.R, Y, Z, dtype=bf, gen=gen)
    record("fused_gemm_combine_h", lambda: kernels.fused_gemm_combine_h(at, bt, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at, bt, l.W),
           2.0 * l.R * X * Y * Z, (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (256, 2048, 8192, 1))
    # attention scores at prefill: 128 groups of (64, 64) @ (64, 80)
    G, X, Y, Z = 128, 32, 32, 40
    at4 = randn(G, l.R, X, Y, dtype=bf, gen=gen)
    bt4 = randn(G, l.R, Y, Z, dtype=bf, gen=gen)
    record("batched_fused_gemm_combine_h",
           lambda: kernels.batched_fused_gemm_combine_h(at4, bt4, l.W),
           lambda: ref.fused_gemm_combine_h_ref(at4, bt4, l.W),
           G * 2.0 * l.R * X * Y * Z, G * (l.R * (X * Y + Y * Z) + 4 * X * Z) * it, fx,
           (64, 64, 80, G))
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


def phase_serve() -> dict:
    cfg = dataclasses.replace(get_config("granite_3_2b"), falcon_mode="strassen")
    params = M.init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_oneshot(cfg, batch=4, prompt_len=64, gen=16, seed=0, device=DEV,
                      params=params)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    logits = torch.stack(res["logits"])
    finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all().item())
    tok = res["tokens"]
    emit("serve", arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         mode=cfg.falcon_mode, batch=4, prompt_len=64, new_tokens=16,
         n_precombined=res["n_precombined"], **res["timings"],
         max_memory_allocated=peak, launches=counts, launches_by_phase=res["launches"],
         logits_finite=finite, sample=tok[0].tolist())
    if res["n_precombined"] != 7:
        raise AssertionError(f"serve: {res['n_precombined']} stacked leaves precombined, "
                             f"expected 7")
    if min(counts.values()) <= 0:
        raise AssertionError(f"serve: a kernel was never launched: {counts}")
    if not finite or logits.shape[-1] != M.padded_vocab(cfg):
        raise AssertionError("serve: logits not finite or of the wrong width")
    if tok.shape != (4, 16) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise AssertionError(f"serve: tokens out of range: {tok}")
    del res
    profile_serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    return counts


def profile_serve(cfg, params) -> None:
    """Where the time goes: device time by kernel over one more one-shot run
    (precombine, prefill, one decode step) under torch.profiler, and the
    share of that window the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_oneshot(cfg, batch=4, prompt_len=64, gen=2, seed=0, device=DEV,
                          params=params)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = lambda e: getattr(e, "self_device_time_total", 0)  # noqa: E731
    dev.sort(key=us, reverse=True)
    device_ms = sum(us(e) for e in dev) / 1e3
    emit("profile", window="precombine + prefill + 1 decode step (profiler on)",
         wall_ms=wall_ms, timings=res["timings"],
         device_ms=device_ms if dev else "not measured",
         busy_share=device_ms / wall_ms if dev else "not measured",
         top=[{"kernel": e.key[:90], "ms": us(e) / 1e3, "calls": e.count}
              for e in dev[:12]])


def phase_decisions() -> None:
    shapes = {"w_q/w_o": (2048, 2048), "w_k/w_v": (2048, 512), "mlp_gate/up": (2048, 8192),
              "mlp_down": (8192, 2048), "lm_head": (2048, 49408)}
    cfg = falcon.FalconConfig()                      # auto mode on h100_sxm
    out = {}
    for M_ in (4, 256, 4096):
        for name, (K, N) in shapes.items():
            for pre in (False, True):
                d = falcon.plan(M_, K, N, cfg, "bfloat16", precombined_b=pre)
                key = f"M={M_} {name}{' precombined' if pre else ''}"
                out[key] = d.algo.name if d.use_lcma else "gemm"
    emit("decisions", hardware=cfg.hardware, decisions=out)


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
    phase_kernels()
    phase_ops()
    times = phase_times()
    phase_parity()
    counts = phase_serve()
    phase_decisions()
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
