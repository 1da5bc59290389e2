"""A configuration, a traffic mix and a per-layer metric added as files (and
entries of BENCHMARK.json) are found by name: no file of the harness is
edited. The smoke cell runs end to end on the CPU."""
from __future__ import annotations

import json

from conftest import TINY_CELL, run_tiny

from portbench.harness.spec import Bench


def test_added_files_are_found_and_run(tiny_root):
    home = tiny_root / "portbench"
    (home / "metrics" / "requests_done.chat.py").write_text(
        '"""requests_done.chat (requests): requests that finished in the window."""\n\n\n'
        "def read(run):\n"
        "    return sum(1 for r in run.requests if r.finish_t is not None\n"
        "               and run.t0 <= r.finish_t <= run.t1)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_done.chat", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine and scheduler", "moves": "prefill_tok_s",
                               "workloads": [TINY_CELL]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Bench(tiny_root, home).cell(TINY_CELL)
    assert cell.config["hidden_size"] == 256 and cell.traffic["clients"] == 4
    result, log = run_tiny(cell, trace=True)
    assert result["correct"], result["checked"]
    assert result["metrics"]["requests_done.chat"]["value"] > 0
    assert "pad_share.prefill" in result["metrics"]
    assert list(result)[-1] == "checked"
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_end_to_end_line_of_the_smoke_cell(tiny_cell):
    result, log = run_tiny(tiny_cell)
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "checked"}
    assert set(result["metrics"]) == {"setup_s", "prefill_tok_s", "ttft_p95_ms"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert log["requests_checked"] >= 2

