"""The port's own spans (``repro_torch.trace``), read for the metrics that
need to know which layer of the program launched a device operation.

The program's span record holds what the port recorded while the
profiler ran (a ``--trace 1`` run's window), on ``time.perf_counter``: the
clock of ``StepRec.t0``/``t1``. On the card an engine step runs three
things on the device: its input copy (one host-to-device copy), the replay
of its bucket's CUDA graph, and its readback (one device-to-host copy).
The step's ``serve.launch`` span carries the graph's capture map: each
device operation of the graph, in the order a replay runs them, with its
kind and the spans (names and attrs) that were open when it was captured.
:func:`lay` lays that over the step's traced operations, in order of start:
the input copy, then the map's nodes, then the readback, where their
number agrees and each operation's kind (kernel, memcpy or memset, read
from its name) is the node's. A step that does not match is left out and
counted. A reader that reads the map returns None where under
``ATTRIBUTED`` of its steps' device seconds were laid.

A program without the span record (the parent of the change that added
it) gives every reader here None.

The spans the port records: ``serve.step``, ``serve.schedule``,
``serve.inputs``, ``serve.launch``, ``serve.readback``, ``serve.emit``, and a
``serve.queue`` span a request from submit to admission (with its ``rid``);
in eager runs, and in the capture map, ``rows.*``, ``model.*`` and
``falcon.leaf`` (M, K, N, the path, and the Decision Module's ``seconds``
and ``gemm_seconds``).

The per-layer metrics that read them (``metrics/<name>.py``):

- ``attention_share.prefill``: device seconds under ``model.attention`` over
  all of the laid prefill steps' device seconds; None below ``ATTRIBUTED``.
- ``lcma_time_vs_plan.prefill``: device seconds of the prefill leaves on an
  LCMA path over the Decision Module's ``seconds`` for them (100: the price
  held); None below ``ATTRIBUTED``.
- ``queue_wait_p95_ms.prefill``: 95th percentile of submit to admission
  (``serve.queue``) over the requests admitted in the window.
- ``launch_lag_ms.prefill``: median host time from ``serve.step``'s entry to
  ``serve.launch``'s, over the window's prefill steps.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import NamedTuple

from .record import tail

__all__ = ["ATTRIBUTED", "program_spans", "steps_ops", "lay", "share_under", "leaf_time_vs_plan",
           "queue_wait_ms", "launch_lag_ms"]

ATTRIBUTED = 0.95


class Frame(NamedTuple):
    """A span the map did not see: the step's input copy and readback."""
    name: str
    attrs: dict


INPUT = (Frame("serve.inputs", {}),)
READBACK = (Frame("serve.readback", {}),)


def program_spans() -> list | None:
    """The port's span record, or None where the program keeps none."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    records = getattr(trace, "records", None)
    return None if records is None else records()


def op_kind(name: str) -> str:
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") \
        else "kernel"


class _Spans:
    """Records of one name, by start."""

    def __init__(self, records: list, name: str):
        self.recs = sorted((r for r in records if r.name == name), key=lambda r: r.t0)
        self.t0 = [r.t0 for r in self.recs]

    def first_in(self, t0: float, t1: float):
        """The first record that starts in [t0, t1], or None."""
        i = bisect.bisect_left(self.t0, t0)
        return self.recs[i] if i < len(self.recs) and self.recs[i].t0 <= t1 else None


@dataclasses.dataclass
class Laid:
    """A kind of step's traced device operations laid over their spans."""
    ops: list                   # (name, seconds, stack, step index) of the laid steps
    device_s: float             # device seconds of every traced step of the kind
    laid_s: float               # of which, in laid steps
    steps: int                  # traced steps of the kind
    left_out: int               # of which, not laid

    @property
    def share(self) -> float:
        return self.laid_s / self.device_s if self.device_s > 0 else 0.0

    @property
    def enough(self) -> bool:
        return self.device_s > 0 and self.share >= ATTRIBUTED


def steps_ops(run) -> dict:
    """Each window step's device operations, (start, name, seconds) in order
    of start, by step index. Every step starts its device work with its one
    host-to-device copy (a captured graph holds none), so the window's
    operations are cut before each such copy, and the pieces go to the
    window's steps in order. The trace's own step of an operation (the host
    span it starts in) is not used where the counts agree: the device's
    clock, as the trace converts it, drifts from the host's by up to a
    short step. Where they do not, each piece goes to the step of its
    middle operation."""
    pieces = []
    for name, s, e, step in run.trace.ops:                 # in order of start
        if not pieces or name.startswith("Memcpy HtoD"):
            pieces.append([])
        pieces[-1].append((s, name, e - s, step))
    if len(pieces) == len(run.steps):
        steps = [st.index for st in run.steps]
    else:
        steps = [piece[len(piece) // 2][3] for piece in pieces]
    out = defaultdict(list)
    for step, piece in zip(steps, pieces):
        if step is not None:
            out[step].extend(op[:3] for op in piece)
    return out


def lay(run, kind: str, records: list | None = None) -> Laid | None:
    """Lay each traced ``kind`` step's device operations over its graph's
    capture map; None without a trace or a span record. Laid once a run
    and kind from the program's record (a traced window holds ~10^6
    operations, and several readers read the same lay)."""
    if records is None:
        done = run.__dict__.setdefault("_laid", {})
        if kind not in done:
            records = program_spans()
            done[kind] = None if records is None else lay(run, kind, records)
        return done[kind]
    if run.trace is None:
        return None
    by_step = steps_ops(run)
    launches = _Spans(records, "serve.launch")
    out = Laid([], 0.0, 0.0, 0, 0)
    for st in run.steps:
        if st.kind != kind or st.index not in by_step:
            continue
        ops = by_step[st.index]
        seconds = sum(sec for _, _, sec in ops)
        out.steps += 1
        out.device_s += seconds
        rec = launches.first_in(st.t0, st.t1)
        nodes = None if rec is None else rec.attrs.get("map")
        stacks = None if nodes is None else \
            [("memcpy", INPUT)] + list(nodes) + [("memcpy", READBACK)]
        if stacks is None or len(stacks) != len(ops) \
                or any(op_kind(name) != k for (_, name, _), (k, _) in zip(ops, stacks)):
            out.left_out += 1
            continue
        out.laid_s += seconds
        out.ops.extend((name, sec, stack, st.index)
                       for (_, name, sec), (_, stack) in zip(ops, stacks))
    return out


def share_under(run, kind: str, span: str, records: list | None = None) -> float | None:
    """Percent of the laid ``kind`` steps' device seconds spent in
    operations captured under a span named ``span``."""
    laid = lay(run, kind, records)
    if laid is None or not laid.enough:
        return None
    under = sum(sec for _, sec, stack, _ in laid.ops if any(f.name == span for f in stack))
    return 100.0 * under / laid.laid_s


def _leaf(stack):
    for f in reversed(stack):
        if f.name == "falcon.leaf":
            return f
    return None


def leaf_time_vs_plan(run, kind: str, paths, records: list | None = None) -> float | None:
    """Percent: the device seconds of the laid ``kind`` steps' leaves
    (``falcon.leaf`` spans) whose path ``paths(path)`` accepts, over the
    sum of the Decision Module's ``seconds`` for them, each leaf counted
    once a step (100: the leaves ran at their price)."""
    laid = lay(run, kind, records)
    if laid is None or not laid.enough:
        return None
    device, leaves = 0.0, {}
    for _, sec, stack, step in laid.ops:
        leaf = _leaf(stack)
        if leaf is not None and paths(leaf.attrs.get("path")):
            device += sec
            leaves[(step, id(leaf))] = leaf.attrs["seconds"]
    priced = sum(leaves.values())
    return 100.0 * device / priced if priced > 0 else None


def queue_wait_ms(run, q: float, records: list | None = None) -> float | None:
    """The ``q``-th percentile of each request's wait from submit to
    admission (``serve.queue`` spans), over requests admitted in the
    window, in milliseconds."""
    records = program_spans() if records is None else records
    if records is None:
        return None
    waits = [r.t1 - r.t0 for r in records
             if r.name == "serve.queue" and run.t0 <= r.t1 <= run.t1]
    t = tail(waits, q)
    return None if t is None else 1e3 * t


def launch_lag_ms(run, kind: str, records: list | None = None) -> float | None:
    """The median host time from a ``kind`` step's entry (``serve.step``)
    to its launch (``serve.launch``), in milliseconds."""
    records = program_spans() if records is None else records
    if records is None:
        return None
    entries, launches = _Spans(records, "serve.step"), _Spans(records, "serve.launch")
    lags = []
    for st in run.steps:
        if st.kind != kind:
            continue
        entry = entries.first_in(st.t0, st.t1)
        launch = None if entry is None else launches.first_in(entry.t0, entry.t1)
        if launch is not None:
            lags.append(launch.t0 - entry.t0)
    t = tail(lags, 50)
    return None if t is None else 1e3 * t
