"""Fixtures of the benchmark's CPU tests: the repository's ``src`` and the
benchmark's package on the path, and a copy of the benchmark with a
smoke-size cell (``data/``) added as files, run on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
TINY_CELL = "tiny.chat"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def add_tiny_cell(root: Path) -> Path:
    """Copy the benchmark under ``root`` and add the smoke cell by adding
    files and one entry of each list of BENCHMARK.json; returns the copy's
    ``portbench`` directory."""
    home = root / "portbench"
    shutil.copytree(REPO / "portbench", home, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(DATA / "tiny.json", home / "configs" / "tiny.json")
    shutil.copy(DATA / "tiny_mix.json", home / "traffic" / "tiny_mix.json")
    shutil.copy(DATA / "tiny.chat.json", home / "cells" / "tiny.chat.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "smoke size"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny", "traffic": "tiny_mix",
                               "chips": 1, "why": "smoke size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in ("prefill_tok_s", "ttft_p95_ms",
                                              "pad_share.prefill"):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return home


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    add_tiny_cell(tmp_path)
    return tmp_path


@pytest.fixture
def tiny_cell(tiny_root):
    from portbench.harness.spec import Bench
    return Bench(tiny_root, tiny_root / "portbench").cell(TINY_CELL)


def run_tiny(cell, seed: int = 2**31 + 5, trace: bool = False, **kw):
    """One run of the smoke cell on the CPU: (result, the log's JSON line)."""
    import time

    from portbench import run
    result, lines = run.run_cell(cell, seed, 1.0, trace, device="cpu",
                                 t_start=time.perf_counter(), **kw)
    return result, json.loads(lines[0].removeprefix("portbench: "))
