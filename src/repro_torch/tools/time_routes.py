"""Time the tiled GEMM off its ``wgmma`` route and Group Combine's narrow-Y
calls on the card, and fit the default f32 calibration.

    python src/repro_torch/tools/time_routes.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` package is timed
(default: this checkout's), so one call on one card can time two trees in
turns (``git archive`` another commit into a directory the repository
ignores and pass its ``src``). Only the package's public wrappers are used:
``kernels.tiled_matmul`` (f32 at the tune probes and decode rows; bf16 from
a misaligned A and from misaligned A and B at the first probe), and
``kernels.batched_group_combine`` (strassen's Combine A at Y = 33, 260 and
1, and at Y rounded up to a multiple of 8 beside each), then the tune CLI
with its default arguments over the three probes (``--no-warm``: the plan
cache's warm-up does not enter the fit). Each result is one JSON line:
device ms from CUDA events around back-to-back calls (median of 5 runs)
and, for Group Combine, the profiler's device time (its calls are shorter
than the wrapper's host cost); beside each its library call (``torch.matmul``
with TF32 off on the same operands, ``torch.einsum`` on a view). The card's
name and power limit open the output. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

PROBES = ((4096, 4096, 4096), (256, 2048, 8192), (256, 8192, 2048), (4, 2048, 8192))
# (groups, X, Y): the attention's Combine A at a padded key count of 66
# (prefill and decode), dbrx's at 520 keys, 64 rows of one column
NARROW = ((128, 32, 33), (128, 1, 33), (192, 64, 260), (128, 64, 1))


def _events_ms(torch, fn, launches: int, runs: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / launches)
    return statistics.median(ts)


def _profiler_ms(torch, fn, launches: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / launches


def _misaligned(torch, t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="time_routes", description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name printed on every line")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import algorithms
    from repro_torch.core.hardware import get_profile
    from repro_torch.kernels import ref
    from repro_torch.tools import tune

    if not torch.cuda.is_available():
        print("time_routes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def emit(**kw):
        print(json.dumps({"tag": args.tag, **kw}), flush=True)

    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi, src=os.path.abspath(args.src))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in PROBES:
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen)
        before = dict(kernels.tiled_matmul.routes)
        got = kernels.tiled_matmul(a, b)
        route = [r for r in before if kernels.tiled_matmul.routes[r] != before[r]]
        want = ref.tiled_matmul_ref(a, b)
        err = ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()
        n = 10 if M == 4096 else 50
        emit(kernel="tiled_matmul", dtype="float32", M=M, K=K, N=N, route=route, err=err,
             ms=_events_ms(torch, lambda: kernels.tiled_matmul(a, b), n),
             torch_matmul_ms=_events_ms(torch, lambda: torch.matmul(a, b), n))
        del a, b, got, want
    for shift in ("a", "ab"):
        a = torch.randn(256, 2048, device="cuda", generator=gen).bfloat16()
        b = torch.randn(2048, 8192, device="cuda", generator=gen).bfloat16()
        a = _misaligned(torch, a)
        if shift == "ab":
            b = _misaligned(torch, b)
        before = dict(kernels.tiled_matmul.routes)
        got = kernels.tiled_matmul(a, b)
        route = [r for r in before if kernels.tiled_matmul.routes[r] != before[r]]
        want = ref.tiled_matmul_ref(a, b)
        err = ((got.float() - want.float()).abs().max()
               / max(1.0, want.float().abs().max().item())).item()
        emit(kernel="tiled_matmul", dtype="bfloat16", M=256, K=2048, N=8192,
             misaligned=shift, route=route, err=err,
             ms=_events_ms(torch, lambda: kernels.tiled_matmul(a, b), 20),
             torch_matmul_ms=_events_ms(torch, lambda: torch.matmul(a, b), 20))
        del a, b, got, want
    l = algorithms.get("strassen")
    c = torch.as_tensor(np.array(l.U, np.float32), dtype=torch.bfloat16, device="cuda")
    for G, X, Y in NARROW:
        for y in (Y, -(-Y // 8) * 8):
            x = torch.randn(G, 2 * X, 2 * y, device="cuda", generator=gen).bfloat16()
            got = kernels.batched_group_combine(x, l.U)
            want = ref.group_combine_ref(ref.split_blocks(x, 2, 2), l.U)
            xv = x.view(G, 2, X, 2, y)
            emit(kernel="batched_group_combine", dtype="bfloat16", G=G, X=X, Y=y,
                 err=(got.float() - want.float()).abs().max().item(),
                 routes=dict(getattr(kernels.batched_group_combine, "routes", {})),
                 ms=_profiler_ms(torch, lambda: kernels.batched_group_combine(x, l.U)),
                 einsum_ms=_profiler_ms(torch, lambda: torch.einsum("ril,gixly->grxy", c, xv)))
            del x, got, want
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(args.src))) as d:
        out = os.path.join(d, "h100_sxm_f32.json")
        argv_tune = [*(s for mkn in PROBES[:3] for s in ("--shape", ",".join(map(str, mkn)))),
                     "--name", "h100_sxm_f32", "--no-warm", "--out", out]
        kernels.reset_launch_counts()
        rc = tune.main(argv_tune)
        with open(out) as f:
            meta = json.load(f)["_metadata"]
    prof = get_profile("h100_sxm_f32")
    emit(calibration="float32", argv=argv_tune, rc=rc, clock=meta.get("clock"),
         flops_mul=prof.flops_mul, lcma_gemm_efficiency=prof.lcma_gemm_efficiency,
         tiled_matmul_routes=dict(kernels.tiled_matmul.routes), probes=meta.get("probes"))
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
