"""The work counts the rooflines and mfu rest on: a product leaf at the
49/64 floor with its bytes once, attention at its real context."""
from __future__ import annotations

import json
from fractions import Fraction
from pathlib import Path

import pytest

from portbench.harness.work import FLOOR, PEAKS, Leaf, Model, least_time, peaks_for, step_leaves

HOME = Path(__file__).resolve().parents[1]


def granite():
    return Model.from_config(json.loads((HOME / "configs" / "granite_3_2b.json").read_text()))


def test_floor_is_the_lowest_rank_ratio_of_the_ports_schemes():
    from repro_torch.core import algorithms
    assert FLOOR == Fraction(49, 64)
    ratios = [Fraction(s.R, s.m * s.k * s.n) for s in algorithms.library().values()
              if s.m * s.k * s.n > 1]
    assert min(ratios) == FLOOR


def test_granite_mlp_up_at_4096_rows():
    m = granite()
    leaves = [leaf for leaf in step_leaves(m, [(4096, 4096)]) if leaf.name == "mlp_up"]
    assert len(leaves) == m.layers
    M, K, N = 4096, 2048, 8192
    assert leaves[0].flops == pytest.approx(2 * M * K * N * 49 / 64)
    assert leaves[0].nbytes == (M * K + K * N + M * N) * 2
    peaks = PEAKS["H100 80GB HBM3"]
    # compute-bound: 2.1e11 floor operations at 989 TFLOP/s, 0.13 GB at 3.35 TB/s
    assert leaves[0].least_s(peaks) == pytest.approx(2 * M * K * N * 49 / 64 / 989e12)


def test_projection_rows_are_real_rows_and_lm_head_one_a_row():
    m = granite()
    leaves = step_leaves(m, [(100, 100), (30, 30)])
    q = [leaf for leaf in leaves if leaf.name == "w_q"][0]
    assert q.flops == pytest.approx(2 * 130 * 2048 * 2048 * 49 / 64)
    head = [leaf for leaf in leaves if leaf.name == "lm_head"]
    assert len(head) == 1 and head[0].flops == pytest.approx(2 * 2 * 2048 * 49155 * 49 / 64)


def test_attention_counts_causal_keys_at_the_real_context():
    m = granite()
    # a prefill row of 4 tokens sees 1+2+3+4 keys; a decode row at context 10 sees 10
    qk = [leaf for leaf in step_leaves(m, [(4, 4), (1, 10)]) if leaf.name == "attn_qk"]
    assert len(qk) == m.layers
    assert qk[0].flops == pytest.approx(2 * 32 * 64 * (10 + 10) * 49 / 64)
    assert qk[0].nbytes == (4 + 10) * 8 * 64 * 2 + 5 * 32 * 64 * 2


def test_decode_step_least_time_is_bytes_bound():
    m = granite()
    peaks = PEAKS["H100 80GB HBM3"]
    rows = [(1, 1000)] * 16
    t = least_time(m, rows, peaks)
    weights = sum(K * N for K, N in m.projections().values()) * m.layers * 2 + 2048 * 49155 * 2
    assert t >= weights / peaks["bytes_per_s"]
    flops = sum(leaf.flops for leaf in step_leaves(m, rows))
    assert t > flops / peaks["bfloat16"]


def test_peaks_known_only_for_the_h100_sxm():
    assert peaks_for("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    assert peaks_for("cpu") is None
    assert Leaf("x", 989e12, 0).least_s(PEAKS["H100 80GB HBM3"]) == pytest.approx(1.0)
