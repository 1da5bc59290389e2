"""The readers of the port's spans (harness/spans.py) on synthetic data: a
traced step laid over its graph's capture map, a step that does not match
left out and counted, no reading below 95% laid, queue waits over the
requests admitted in the window, and the launch lag."""
from __future__ import annotations

import json
from collections import namedtuple
from pathlib import Path

import pytest
from conftest import TINY_CELL, run_tiny

from portbench.harness import spans
from portbench.harness.record import Run, StepRec
from portbench.harness.spec import Bench
from portbench.harness.trace import Trace

Rec = namedtuple("Rec", "name attrs parent t0 t1")
F = namedtuple("F", "name attrs")
ATTN, MLP = F("model.attention", {}), F("model.mlp", {})
LEAF = F("falcon.leaf", {"path": "s444", "seconds": 1e-3})
GEMM = F("falcon.leaf", {"path": "gemm", "seconds": 1e-3})
# a graph: two attention kernels, an s444 leaf (two kernels) and a GEMM leaf in the MLP
MAP = (("kernel", (ATTN,)), ("kernel", (ATTN,)), ("kernel", (MLP, LEAF)),
       ("kernel", (MLP, LEAF)), ("kernel", (MLP, GEMM)))
KERNELS = ["softmax", "where", "fused_tc_kernel", "group_combine", "nvjet"]


def step_ops(t, index, step=None, seconds=(4e-3, 2e-3, 3e-3, 1e-3, 1e-3), kernels=KERNELS):
    """A step's traced ops from ``t``: the input copy, its graph, the
    readback; ``step``: the step the trace gave them (default ``index``)."""
    names = ["Memcpy HtoD (Pageable -> Device)"] + list(kernels) + ["Memcpy DtoH (Device -> Pageable)"]
    secs = [1e-5] + list(seconds) + [1e-5]
    ops = []
    for name, sec in zip(names, secs):
        ops.append((name, t, t + sec, index if step is None else step))
        t += sec
    return ops


def make_run(n, maps=None, skew=False, t0=0.0):
    """``n`` prefill steps of 1 s each from ``t0``, each traced and
    launched with ``MAP`` (or ``maps[i]``); ``skew``: the trace gives each
    step's input copy to the step before."""
    steps, ops, recs = [], [], []
    for i in range(n):
        s0 = t0 + i
        steps.append(StepRec(i, "prefill", s0, s0 + 1.0, 1, 2048, 2000, 1, [(2000, 2000)]))
        got = step_ops(s0 + 0.1, i)
        if skew and i:
            got[0] = got[0][:3] + (i - 1,)
        ops += got
        recs += [Rec("serve.step", {}, None, s0 + 0.001, s0 + 0.9),
                 Rec("serve.launch", {"key": ("prefill", 1, 2048),
                                      "map": MAP if maps is None else maps[i]},
                     "serve.step", s0 + 0.002, s0 + 0.003)]
    run = Run("c", {}, {}, 1.0, t0, t0 + n, steps, [], None,
              Trace(float(n), ops, []))
    return run, recs


def test_a_matched_step_is_laid_op_by_op():
    run, recs = make_run(3)
    laid = spans.lay(run, "prefill", recs)
    assert (laid.steps, laid.left_out) == (3, 0) and laid.share == pytest.approx(1.0)
    first = [(name, [f.name for f in stack]) for name, _, stack, step in laid.ops if step == 0]
    assert first == [("Memcpy HtoD (Pageable -> Device)", ["serve.inputs"]),
                     ("softmax", ["model.attention"]), ("where", ["model.attention"]),
                     ("fused_tc_kernel", ["model.mlp", "falcon.leaf"]),
                     ("group_combine", ["model.mlp", "falcon.leaf"]),
                     ("nvjet", ["model.mlp", "falcon.leaf"]),
                     ("Memcpy DtoH (Device -> Pageable)", ["serve.readback"])]
    total = 3 * (11e-3 + 2e-5)
    assert spans.share_under(run, "prefill", "model.attention", recs) == \
        pytest.approx(100 * 3 * 6e-3 / total)
    # the s444 leaf: 4 ms of kernels a step against its 1-ms price
    assert spans.leaf_time_vs_plan(run, "prefill", lambda p: p != "gemm", recs) == \
        pytest.approx(400.0)
    assert spans.leaf_time_vs_plan(run, "prefill", lambda p: p == "gemm", recs) == \
        pytest.approx(100.0)
    assert spans.share_under(run, "decode", "model.attention", recs) is None


def test_steps_take_their_pieces_in_order_though_the_clocks_drift():
    run, recs = make_run(4, skew=True)
    assert spans.lay(run, "prefill", recs).left_out == 0
    # where the pieces and the steps do not agree in number, the middle op decides
    run.trace.ops.append(("Memcpy HtoD (Pageable -> Device)", 3.95, 3.96, 3))
    laid = spans.lay(run, "prefill", recs)
    assert (laid.steps, laid.left_out) == (4, 1)


def test_a_step_whose_count_differs_is_left_out_and_counted():
    short = MAP[:-1]
    run, recs = make_run(40, maps=[short] + [MAP] * 39)
    laid = spans.lay(run, "prefill", recs)
    assert (laid.steps, laid.left_out) == (40, 1)
    assert laid.share == pytest.approx(39 / 40) and laid.enough
    # a kind that differs counts as a mismatch too
    memset = (("memset", (ATTN,)),) + MAP[1:]
    run, recs = make_run(3, maps=[memset, MAP, MAP])
    assert spans.lay(run, "prefill", recs).left_out == 1
    # a step launched without a map (an eager step, or a parent program)
    run, recs = make_run(3, maps=[None, MAP, MAP])
    assert spans.lay(run, "prefill", recs).left_out == 1


@pytest.mark.parametrize("reader", ["attention", "lcma"])
def test_each_map_reader_reads_nothing_below_95_percent_laid(reader):
    def read(run, recs):
        if reader == "attention":
            return spans.share_under(run, "prefill", "model.attention", recs)
        return spans.leaf_time_vs_plan(run, "prefill", lambda p: p != "gemm", recs)

    run, recs = make_run(25, maps=[MAP[:-1]] + [MAP] * 24)       # 96% laid
    assert read(run, recs) is not None
    run, recs = make_run(25, maps=[MAP[:-1]] * 2 + [MAP] * 23)   # 92% laid
    assert read(run, recs) is None
    run.trace = None
    assert read(run, recs) is None


def test_queue_wait_is_taken_over_requests_admitted_in_the_window():
    run, _ = make_run(10, t0=100.0)                 # the window: [100, 110]
    waits = [0.5, 1.0, 2.0, 4.0]
    recs = [Rec("serve.queue", {"rid": i}, None, 101.0 + i, 101.0 + i + w)
            for i, w in enumerate(waits)]
    recs += [Rec("serve.queue", {"rid": 9}, None, 80.0, 99.0),      # admitted before
             Rec("serve.queue", {"rid": 8}, None, 105.0, 140.0)]    # after
    assert spans.queue_wait_ms(run, 50, recs) == pytest.approx(1e3 * 1.5)
    assert spans.queue_wait_ms(run, 100, recs) == pytest.approx(4e3)
    assert spans.queue_wait_ms(run, 95, []) is None


def test_launch_lag_is_the_median_from_step_entry_to_launch():
    run, recs = make_run(3)
    assert spans.launch_lag_ms(run, "prefill", recs) == pytest.approx(1.0)
    assert spans.launch_lag_ms(run, "decode", recs) is None


def test_a_program_without_the_span_record_reads_nothing(monkeypatch):
    run, recs = make_run(3)
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert spans.lay(run, "prefill") is None
    assert spans.share_under(run, "prefill", "model.attention") is None
    assert spans.queue_wait_ms(run, 95) is None
    assert spans.launch_lag_ms(run, "prefill") is None


NEW = ("attention_share.prefill", "lcma_time_vs_plan.prefill", "queue_wait_p95_ms.prefill",
       "launch_lag_ms.prefill")


def test_the_smoke_cell_reads_the_host_span_metrics_on_the_cpu(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(TINY_CELL)
    Path(tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Bench(tiny_root, tiny_root / "portbench").cell(TINY_CELL)
    result, _ = run_tiny(cell, trace=True)
    got = result["metrics"]
    # no device operations on the CPU: nothing to lay, so the map readers stay silent
    assert "attention_share.prefill" not in got and "lcma_time_vs_plan.prefill" not in got
    assert got["queue_wait_p95_ms.prefill"]["value"] >= 0
    assert got["launch_lag_ms.prefill"]["value"] > 0
