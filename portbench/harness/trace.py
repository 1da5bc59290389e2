"""The device trace of a window (``--trace 1``): torch.profiler over the
window, exported as a Chrome trace and reduced to device intervals.

Device operations are the trace's kernels, copies and sets. ``busy_s`` is
the length of the union of their intervals inside the window, the
``portbench.window`` span; each operation belongs to the ``portbench.step``
span it starts in (a step ends in its one synchronisation, so its work
starts and ends inside its span). An idle gap, a stretch of the window with
no device operation, is named by what the host was doing at its middle: the
harness's innermost span (``portbench.step``, ``portbench.clients``,
``portbench.submit``) and the innermost host operation inside it.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
from collections import defaultdict

__all__ = ["Trace", "Tracer", "span"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 200        # a breakdown's operation names, cut to this length


def span(name: str):
    """A host span the trace keeps (``record_function``); free without a
    profiler running."""
    from torch.profiler import record_function
    return record_function(name)


@dataclasses.dataclass
class Trace:
    """A window's device operations, in seconds from the window's start."""
    window_s: float
    ops: list               # (name, start, end, step or None), sorted by start
    idle: list              # (label, seconds) of each idle gap

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, 0.0
        for _, s, e, _ in self.ops:
            s, e = max(s, end), min(e, self.window_s)
            if e > s:
                busy += e - s
                end = e
        return busy

    def op_seconds(self, step_kinds=None, match=None) -> dict:
        """Device seconds by operation name, of the ops in steps whose index
        is in ``step_kinds`` (all where None) whose name ``match`` accepts."""
        out = defaultdict(float)
        for name, s, e, step in self.ops:
            if (step_kinds is None or step in step_kinds) and (match is None or match(name)):
                out[name] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = defaultdict(float)
        for label, sec in self.idle:
            gaps[label] += sec
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}


def _innermost(events: list, starts: list, t: float):
    """The event of ``events`` (sorted by start; ``starts`` their starts)
    that covers ``t`` and starts last."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 64), -1):
        ts, te, name = events[j]
        if ts <= t <= te:
            best = name
            break
    return best


def reduce_trace(events: list, step_indices: list) -> Trace:
    """Reduce Chrome trace events to a :class:`Trace`. ``step_indices``:
    the run's index of each ``portbench.step`` span, in order."""
    window = [e for e in events if e.get("name") == "portbench.window" and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no portbench.window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                   and e["name"].startswith("portbench.") and e["name"] != "portbench.window")
    steps = [(s, t) for s, t, n in spans if n == "portbench.step"]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X")
    step_starts = [s for s, _ in steps]
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if t <= w0 or s >= w1:
            continue
        i = bisect.bisect_right(step_starts, s) - 1
        step = step_indices[i] if 0 <= i < len(steps) and s <= steps[i][1] \
            and i < len(step_indices) else None
        ops.append((e["name"], (max(s, w0) - w0) / 1e6, (min(t, w1) - w0) / 1e6, step))
    ops.sort(key=lambda o: o[1])
    span_starts = [s for s, _, _ in spans]
    host_starts = [s for s, _, _ in host]
    idle, end = [], 0.0
    window_s = (w1 - w0) / 1e6
    for _, s, e, _ in ops + [("", window_s, window_s, None)]:
        if s > end:
            mid = w0 + (end + s) / 2 * 1e6
            outer = _innermost(spans, span_starts, mid) or "outside spans"
            inner = _innermost(host, host_starts, mid)
            idle.append((outer if inner is None else f"{outer} / {inner}", s - end))
        end = max(end, e)
    return Trace(window_s, ops, idle)


class Tracer:
    """torch.profiler over a window. ``window()`` is the span to trace in;
    ``reduce(step_indices)`` reads the profile. The Chrome trace goes to
    ``path`` and is removed once read."""

    def __init__(self, path: str):
        from torch.profiler import ProfilerActivity, profile
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    @contextlib.contextmanager
    def window(self):
        self.prof.start()
        try:
            with span("portbench.window"):
                yield
        finally:
            self.prof.stop()

    def reduce(self, step_indices: list) -> Trace:
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return reduce_trace(events, step_indices)
