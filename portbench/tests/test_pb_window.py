"""Window arithmetic: rates over the whole window, tails over every sample,
requests and steps that straddle the window's edges."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.harness.record import ReqRec, Run, StepRec, overlap, tail


def step(i, kind, t0, t1, real, emitted=0, batch=1, seq=1):
    return StepRec(i, kind, t0, t1, batch, seq, real, emitted, [])


def make_run(steps, requests=(), t0=10.0, t1=20.0):
    return Run("c", {}, {}, 1.0, t0, t1, list(steps), list(requests), None)


def test_rate_is_window_work_over_window_seconds_with_straddling_step_prorated():
    steps = [step(0, "prefill", 10.0, 12.0, 1000),
             step(1, "decode", 12.0, 13.0, 8, emitted=8),
             step(2, "prefill", 13.0, 19.0, 3000),
             step(3, "prefill", 19.0, 23.0, 4000)]     # 1 of its 4 s inside
    run = make_run(steps)
    assert run.rate("prefill", "real_tokens") == pytest.approx((1000 + 3000 + 1000) / 10.0)
    assert run.rate("decode", "emitted") == pytest.approx(8 / 10.0)


def test_rate_divides_by_the_window_not_by_step_time():
    # 1000 tokens in a 5-s step, then 5 s with no step: a stall between
    # steps shows (the engine's own tokens_per_s would read 200)
    stalled = make_run([step(0, "prefill", 10.0, 15.0, 1000)])
    assert stalled.rate("prefill", "real_tokens") == pytest.approx(100.0)


def test_overlap_edges():
    assert overlap(0.0, 2.0, 1.0, 5.0) == pytest.approx(0.5)
    assert overlap(6.0, 7.0, 1.0, 5.0) == 0.0
    assert overlap(2.0, 3.0, 1.0, 5.0) == 1.0
    assert overlap(3.0, 3.0, 1.0, 5.0) == 1.0


def test_tail_is_over_all_samples():
    x = np.arange(1, 1001, dtype=float)
    assert tail(x, 95) == pytest.approx(np.percentile(x, 95))
    assert tail(x, 99) == pytest.approx(990.01)
    assert tail([], 95) is None
    # one slow request among many moves the 99th percentile, not a median of chunks
    y = [1.0] * 99 + [1000.0]
    assert tail(y, 99) > 1.0


def test_ttft_counts_requests_whose_first_token_falls_in_the_window():
    reqs = [ReqRec(0, 10, 4, submit_t=8.0, first_t=9.5),        # before: out
            ReqRec(1, 10, 4, submit_t=9.0, first_t=10.5),       # straddles t0: in
            ReqRec(2, 10, 4, submit_t=15.0, first_t=16.0),      # in
            ReqRec(3, 10, 4, submit_t=19.5, first_t=21.0),      # after: out
            ReqRec(4, 10, 4, submit_t=19.9, first_t=None)]      # never: out
    run = make_run([], reqs)
    assert sorted(run.ttfts()) == pytest.approx([1.0, 1.5])


def test_gaps_are_those_that_end_in_the_window():
    r = ReqRec(0, 10, 6, submit_t=5.0, token_t=[9.0, 9.8, 10.1, 15.0, 20.0, 20.5])
    run = make_run([], [r])
    # 9.0->9.8 ends before t0; 9.8->10.1 straddles t0 and ends in it;
    # 20.0->20.5 ends after t1
    assert sorted(run.gaps()) == pytest.approx(sorted([0.3, 4.9, 5.0]))


def test_weighted_steps_filter_kind_and_drop_outside_steps():
    steps = [step(0, "prefill", 5.0, 9.0, 10), step(1, "decode", 9.0, 11.0, 2),
             step(2, "decode", 11.0, 12.0, 2)]
    got = [(s.index, w) for s, w in make_run(steps).weighted_steps("decode")]
    assert got == [(1, pytest.approx(0.5)), (2, 1.0)]
