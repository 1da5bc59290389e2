"""On the card (marker ``cuda``; skipped elsewhere): each cell at its own
size, one short window: the program correct, and the float8 control, judged
by the same code in the program's place, not correct. Run there as

    python3 -m pytest -q -m cuda portbench/tests/test_pb_card.py
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, name):
    from portbench import run
    from portbench.harness.spec import Bench
    cell = Bench(REPO).cell(name)
    result, lines = run.run_cell(cell, 2**31 + 101, 15.0, False, t_start=time.perf_counter(),
                                 control=True)
    log = json.loads(lines[0].removeprefix("portbench: "))
    assert result["correct"], result["checked"]
    assert log["control"]["correct"] is False, log["control"]
