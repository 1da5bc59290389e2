"""BENCHMARK.json and the benchmark's data files: names, units and keys in
the allowed characters and shapes, and every name found as a file."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.harness.spec import NAME, UNIT, Bench
from portbench.harness.traffic import Deck, check_mix

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank|_size)$"
                   r"|num_experts_per_tok|experts_per_token")

KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys_and_valid_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_configs_files_and_reduced():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        spec = json.loads((REPO / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.match(key), key
            assert key in spec, key
        # what the program runs in place of a published value changes no width
        for key in spec.get("run_as", {}):
            assert key in spec and not WIDTH.match(key), key


def test_every_name_is_a_file():
    bench = Bench(REPO)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        cell = bench.cell(w["name"])
        check_mix(cell.traffic)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert cell.traffic["name"] == w["traffic"]
        assert {"requests", "min_served_tokens", "limits"} <= set(cell.check)
        assert (HOME / "models" / f"{cell.config['family']}.py").exists()
        assert (HOME / "reference" / f"{cell.config['family']}.py").exists()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)
    for path in HOME.rglob("*"):
        rel = path.relative_to(HOME).as_posix()
        if "__pycache__" not in rel:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_a_check_at_the_full_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (HOME / "traffic").glob("*.json")))
def test_decks_are_the_same_sizes_for_every_seed(traffic):
    mix = json.loads((HOME / "traffic" / f"{traffic}.json").read_text())
    a, b = Deck(mix, 1000, 1), Deck(mix, 1000, 2**31 + 9)
    n = mix["deck"]
    sizes = lambda d: sorted((int(d.prompt[d.entry(j)]), int(d.output[d.entry(j)])) for j in range(n))  # noqa: E731
    assert sizes(a) == sizes(b)
    # the same order too: in a loop that batches prompts, the order sets the work
    assert [a.entry(j) for j in range(3 * n)] == [b.entry(j) for j in range(3 * n)]
    assert [a.entry(j) for j in range(n)] != [a.entry(j) for j in range(n, 2 * n)]
    assert a.max_prompt <= max(mix["prefill_seq_buckets"])
    toks, out = a.request(3, 0, False)
    again, _ = Deck(mix, 1000, 1).request(3, 0, False)
    assert (toks == again).all() and toks.max() < 1000 and out >= 1
