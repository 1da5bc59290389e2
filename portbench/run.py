"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the weights and the requests come
from ``--seed``. Set-up builds the port's kernels (kept under
``build/kernels/`` in the checkout, so only a checkout's first run compiles
them), draws the weights on the card, builds and warms the port's serve
engine on the mix's bucket grid; then closed-loop clients run for the mix's
ramp and for a window of ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a run whose
window runs under torch.profiler. Each metric is read by
``portbench/metrics/<name>.py``.

After the window: the peak device memory is read, the program's state is
freed, and a sample of the served requests goes through the plain reference
(``portbench/harness/check.py``); ``correct`` says whether every compared
number is within its limit (``portbench/cells/<cell>.json``). The last line
of standard output is the result, one JSON object; the compared numbers and
their limits are the last lines of standard error and the result's last key.

Exits non-zero with no result where there is no CUDA card (or fewer than the
cell asks for), where the port cannot be imported, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse     # noqa: E402
import contextlib   # noqa: E402
import gc           # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import subprocess   # noqa: E402
import sys          # noqa: E402
from pathlib import Path    # noqa: E402

import numpy as np          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout, for
    any library that honours them (the port's own kernels build into
    ``build/kernels/``)."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    base.mkdir(parents=True, exist_ok=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, tamper=None, control: bool = False) -> tuple[dict, list]:
    """Run ``cell`` (a ``harness.spec.Cell``): (the result, the lines that
    end standard error). ``tamper(engine)``, for the benchmark's own tests,
    breaks the program after its warm-up; ``control`` also judges the float8
    control over the same sample, as the program is judged
    (``portbench/control.py``)."""
    import torch

    from portbench.harness import check, serve
    from portbench.harness.record import Run
    from portbench.harness.trace import Tracer
    from portbench.harness.traffic import Deck

    gc.collect()            # an earlier run's engine, in the same process
    if device == "cuda":
        torch.cuda.empty_cache()
    adapter, reference = cell.model_module("models"), cell.model_module("reference")
    spec, mix = reference.as_run(cell.config), cell.traffic
    cfg = adapter.port_config(spec)
    cuda = device == "cuda"
    if cuda:
        from repro_torch.kernels import build
        build.build_all()
    weights = reference.make_weights(spec, seed, device)
    deck = Deck(mix, spec["vocab_size"], seed)
    engine, warm = serve.build_engine(cfg, weights, mix, deck, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    loop = serve.Loop(engine, deck)
    loop.start()
    loop.run_until(time.perf_counter() + float(mix["ramp_s"]))
    if tamper is not None:
        tamper(engine)
    launches0 = serve.launch_state()
    tracer = Tracer(str(ROOT / "build" / "portbench" / f"trace-{cell.name}.json")) \
        if trace else None
    with tracer.window() if tracer else contextlib.nullcontext():
        t0 = time.perf_counter()
        t1 = t0 + seconds
        steps = loop.run_until(t1)
    launches = serve.launch_state() - launches0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(cell.name, spec, mix, setup_s, t0, t1, steps, loop.requests,
              launches if cuda else None)
    tr = time.perf_counter()
    run.trace = tracer.reduce([s.index for s in steps]) if tracer else None
    reduce_s = time.perf_counter() - tr
    run.device = {"name": torch.cuda.get_device_name(0) if cuda else "cpu"}

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, on the program's state freed
    picked = check.sample(engine.requests, t0, t1, cell.check["requests"], seed)
    seqs, pos, toks = check.served(picked)
    n_picked = len(picked)
    attempted = sum(1 for r in loop.requests if r.token_t and r.token_t[-1] >= t0)
    # the engine's requests hold the loop's callback, which holds the engine
    del engine, loop, warm, picked
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    ref = reference.Reference(spec, weights).logits(seqs, pos)
    g = check.gaps(ref, toks)
    checked, correct = check.judge(g, cell.check)
    extra = {"trace_reduce_s": reduce_s, "requests_checked": n_picked, "check_s": time.perf_counter() - tc,
             "gap_quantiles": [float(q) for q in np.quantile(g, [0.5, 0.9, 0.99])] if len(g) else [],
             "top1_differs": float((g > 0).mean()) if len(g) else None}
    if control:
        # the float8 reference in the program's place, judged as the program is
        ctl = reference.Reference(spec, weights, precision="fp8").logits(seqs, pos)
        cg = check.gaps(ref, check.control_tokens(ctl))
        ctl_checked, ctl_correct = check.judge(cg, cell.check)
        extra["control"] = {"correct": ctl_correct, "checked": ctl_checked,
                            "top1_differs": float((cg > 0).mean()) if len(cg) else None}

    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device["name"],
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checked"] = checked
    lines = [f"portbench: {json.dumps({'setup_s': setup_s, 'window': window_line(run, steps), **extra})}"]
    lines += [f"check {k} {v['value']} limit {v['limit']}" for k, v in checked.items()]
    return result, lines


def window_line(run, steps) -> dict:
    """The window's steps by shape (count, seconds) and the run's requests,
    for the log."""
    shapes = {}
    for s in steps:
        n, sec = shapes.get(f"{s.kind} {s.batch}x{s.seq}", (0, 0.0))
        shapes[f"{s.kind} {s.batch}x{s.seq}"] = (n + 1, sec + s.t1 - s.t0)
    return {"steps": len(steps), "by_shape": shapes, "requests": len(run.requests),
            "window_s": run.seconds}


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from portbench.harness.spec import Bench
        cell = Bench(Path.cwd()).cell(args.workload)
        cache_dirs(ROOT)
        import torch
        import repro_torch  # noqa: F401
    except (ImportError, OSError, KeyError, ValueError) as e:
        print(f"portbench: cannot start: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    # read after the window, so nvidia-smi's time is not set-up
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
