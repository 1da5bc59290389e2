"""The trace's reduction and the per-layer readers on synthetic data."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import pytest

from portbench.harness import readers
from portbench.harness.record import Run, StepRec
from portbench.harness.trace import reduce_trace

HOME = Path(__file__).resolve().parents[1]
GRANITE = json.loads((HOME / "configs" / "granite_3_2b.json").read_text())


def X(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


EVENTS = [
    X("portbench.window", 1000.0, 1000.0, "user_annotation"),
    X("portbench.step", 1000.0, 400.0, "user_annotation"),
    X("cudaGraphLaunch", 1010.0, 5.0, "cuda_runtime"),
    X("nvjet_tst_256x128", 1020.0, 100.0, "kernel"),
    X("elementwise_kernel", 1100.0, 100.0, "kernel"),     # overlaps the first
    X("cudaMemcpyAsync", 1250.0, 140.0, "cuda_runtime"),
    X("portbench.clients", 1400.0, 50.0, "user_annotation"),
    X("portbench.step", 1500.0, 400.0, "user_annotation"),
    X("fused_tc_kernel", 1510.0, 300.0, "kernel"),
    X("Memcpy DtoH", 1850.0, 10.0, "gpu_memcpy"),
    X("nvjet_outside", 2100.0, 50.0, "kernel"),           # after the window
]


def test_busy_is_the_union_and_ops_belong_to_their_step():
    tr = reduce_trace(EVENTS, [7, 8])
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((180 + 300 + 10) * 1e-6)
    by = {name: step for name, _, _, step in tr.ops}
    assert by == {"nvjet_tst_256x128": 7, "elementwise_kernel": 7, "fused_tc_kernel": 8,
                  "Memcpy DtoH": 8}
    assert tr.op_seconds({8})["fused_tc_kernel"] == pytest.approx(300e-6)


def test_idle_gaps_are_named_by_the_host():
    tr = reduce_trace(EVENTS, [7, 8])
    gaps = dict((k, v) for k, v in tr.breakdown()["idle_gaps"])
    # each gap named by the host at its middle
    assert gaps == {"portbench.step / cudaGraphLaunch": pytest.approx(20e-6),
                    "portbench.step / cudaMemcpyAsync": pytest.approx(310e-6),
                    "portbench.step": pytest.approx(40e-6),
                    "outside spans": pytest.approx(140e-6)}
    assert sum(gaps.values()) == pytest.approx(1e-3 - tr.busy_s)
    assert tr.breakdown()["device_ops"][0] == ["fused_tc_kernel", pytest.approx(300e-6)]


def run_with(steps, launches=None, trace=None):
    run = Run("c", GRANITE, {}, 1.0, 0.0, 10.0, steps, [], launches, trace)
    run.device = {"name": "NVIDIA H100 80GB HBM3"}
    return run


def test_lcma_share_reads_the_fused_launches():
    steps = [StepRec(0, "prefill", 0.0, 1.0, 1, 2048, 2000, 1, [(2000, 2000)])]
    per_layer = 2 * 2048 * (2048 * 3072 + 2048 * 2048 + 3 * 2048 * 8192)
    total = 40 * per_layer + 2 * 1 * 2048 * 49155
    # mlp_gate and mlp_up on s444 in all 40 layers: (49, 512, 512) x (49, 512, 2048)
    launches = Counter({("fused_gemm_combine_h", ((49, 512, 512), (49, 512, 2048))): 80})
    share = readers.lcma_share(run_with(steps, launches), ("fused_gemm_combine_h",))
    assert share == pytest.approx(100 * 80 * 2 * 2048 * 2048 * 8192 / total)
    assert readers.lcma_share(run_with(steps, None), ("fused_gemm_combine_h",)) is None


def test_mfu_and_roofline_stay_under_100_for_work_that_takes_its_least_time():
    rows = [(2048, 2048)]
    from portbench.harness.work import PEAKS, Model, least_time, step_leaves
    model, peaks = Model.from_config(GRANITE), PEAKS["H100 80GB HBM3"]
    t = least_time(model, rows, peaks)
    # each leaf at its own bound, back to back: the products' least time
    t_leaves = sum(leaf.least_s(peaks) for leaf in step_leaves(model, rows))
    assert t_leaves >= t
    steps = [StepRec(0, "prefill", 0.0, 10.0, 1, 2048, 2048, 1, rows)]
    assert readers.mfu(run_with(steps)) == pytest.approx(100 * t / 10.0)
    events = [X("portbench.window", 0.0, 1e7, "user_annotation"),
              X("portbench.step", 0.0, 1e7, "user_annotation"),
              X("nvjet_x", 10.0, t_leaves * 1e6, "kernel"), X("softmax", 2e6, 1e6, "kernel")]
    run = run_with(steps, trace=reduce_trace(events, [0]))
    assert readers.matmul_roofline(run, "prefill", "nvjet") == pytest.approx(100.0)
    assert readers.matmul_roofline(run, "decode", "nvjet") is None
    assert readers.device_idle(run) == pytest.approx(100 * (1 - (t_leaves + 1.0) / 10.0))
    run.trace = None
    assert readers.matmul_roofline(run, "prefill", "nvjet") is None
