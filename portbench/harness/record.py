"""What a run leaves for the metrics to read, and the window's arithmetic.

The window is [t0, t1] on the host's clock (``time.perf_counter``). Steps
run back to back; t0 falls between two steps, and the window closes with the
first step that ends at or after t1, whose share inside the window is
``overlap``. Rates are the window's work over the window's seconds, with a
step that straddles the edge counted in proportion; tails are over every
sample whose time falls in the window.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

__all__ = ["StepRec", "ReqRec", "Run", "tail", "overlap"]


@dataclasses.dataclass
class StepRec:
    """One engine step as the client saw it. ``rows``: per real row, the
    tokens it ran (q) and the length of its context after the step (kv),
    so its attention covers keys [0, kv) for queries [kv - q, kv)."""
    index: int
    kind: str                       # "prefill" | "decode"
    t0: float
    t1: float
    batch: int                      # the bucket's rows (padded)
    seq: int                        # the bucket's tokens a row (1 at decode)
    real_tokens: int                # prompt tokens, or decode rows
    emitted: int                    # tokens delivered to clients
    rows: list                      # [(q, kv), ...] of the real rows

    @property
    def padded_tokens(self) -> int:
        return self.batch * self.seq


@dataclasses.dataclass
class ReqRec:
    """One request: its lengths and the client's clock readings."""
    rid: int
    prompt_len: int
    out_len: int
    submit_t: float
    first_t: float | None = None
    finish_t: float | None = None
    token_t: list = dataclasses.field(default_factory=list)


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """The share of [a0, a1] that lies inside [b0, b1]."""
    if a1 <= a0:
        return float(b0 <= a0 <= b1)
    return max(0.0, min(a1, b1) - max(a0, b0)) / (a1 - a0)


def tail(samples, q: float) -> float | None:
    """The ``q``-th percentile of every sample (linear between order
    statistics); None without samples."""
    if len(samples) == 0:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), q))


@dataclasses.dataclass
class Run:
    """A run's window, for the metric readers (``metrics/<name>.py``)."""
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    t0: float
    t1: float
    steps: list                     # StepRec of the window (and the straddling one)
    requests: list                  # ReqRec of every request the run sent
    launches: Counter | None        # the program's launch counters over ``steps``
    trace: object = None            # harness.trace.Trace of a --trace 1 run
    device: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def weighted_steps(self, kind: str | None = None):
        """(step, share inside the window) of each step of ``kind``."""
        for s in self.steps:
            if kind is None or s.kind == kind:
                w = overlap(s.t0, s.t1, self.t0, self.t1)
                if w > 0:
                    yield s, w

    def rate(self, kind: str, attr: str) -> float:
        """Steps' ``attr`` summed over the window, per second of it."""
        return sum(getattr(s, attr) * w for s, w in self.weighted_steps(kind)) / self.seconds

    def ttfts(self) -> list:
        """Time to first token of each request whose first token fell in
        the window, in seconds."""
        return [r.first_t - r.submit_t for r in self.requests
                if r.first_t is not None and self.t0 <= r.first_t <= self.t1]

    def gaps(self) -> list:
        """Every gap between consecutive tokens of a request that ends in
        the window, in seconds."""
        out = []
        for r in self.requests:
            t = np.asarray(r.token_t, np.float64)
            if len(t) > 1:
                g = np.diff(t)
                out.extend(g[(t[1:] >= self.t0) & (t[1:] <= self.t1)].tolist())
        return out
