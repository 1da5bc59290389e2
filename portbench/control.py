"""Readings that set a cell's check limit: for each seed, one run of the
cell as ``run.py`` makes it (set-up, ramp, a window of ``--seconds``), its
``logit_gap`` and ``correct``, and the float8 control's, the control put in
the program's place over the same sample and judged by the same code
(``harness/check.py``: ``judge``). All seeds run in one process, so the
kernels load once; each seed draws its own weights and builds its own
engine. Exits 5 where the control comes out correct on any seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

One JSON line a seed on standard output. The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench.harness.spec import Bench
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    run.cache_dirs(run.ROOT)
    cell = Bench(Path.cwd()).cell(args.workload)
    print(f"control: card {run.power_limit()}", file=sys.stderr)
    control_passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        result, lines = run.run_cell(cell, seed, args.seconds, False, t_start=t, control=True)
        extra = json.loads(lines[0].removeprefix("portbench: "))
        ctl = extra.pop("control")
        control_passed |= ctl["correct"]
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": result["correct"],
                          "logit_gap": result["checked"]["logit_gap"]["value"],
                          "control_correct": ctl["correct"],
                          "control_gap": ctl["checked"]["logit_gap"]["value"],
                          "control_top1_differs": ctl["top1_differs"], **extra,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"]}),
              flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"control: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    if control_passed:
        print("control: the float8 control came out correct", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
