"""Bucket steps, each captured once as a CUDA graph and replayed.

The reference runs each bucket shape of its engine as one compiled ``jit``
executable. Here a bucket's step is a :class:`Step`: a function of
fixed-shape int64 inputs (tokens, offsets, slot indices) that reads and
writes tensors living outside it (the weights, the slot caches), and
returns fixed-shape outputs. :class:`StepGraphs` makes one per bucket key.

On the card, with graphs on, a new step runs once eagerly on a side stream
(so what a first call builds lazily, such as a scheme's coefficient table
on the card or cuBLAS's workspace, exists before the capture: a pageable
host-to-device copy is illegal inside one), then is captured into a CUDA
graph whose memory comes from one pool that all of an engine's graphs
share. Each later call copies its inputs into the step's static buffer
(one host-to-device copy) and replays the graph: no Python runs in the
step, so its plans are those fixed at capture, as jit fixes them at trace.
Elsewhere (the CPU, or ``enabled=False``) the same function runs eagerly on
each call, after one eager warm-up run. A capture that fails raises:
nothing falls back to eager.

Graph replays call no kernel wrapper, so the wrappers' launch counters
(``repro_torch.kernels``) would miss them. Each graph keeps the counts its
capture added (and takes them back, since a capture launches nothing) and
adds them again on every replay, so the counters stay true.

A replay overwrites the graph's outputs: read them, or copy what must
outlive the step, before the same step runs again.

A replay runs no span (``repro_torch.trace``) either. The capture counts
the graph's device-operation nodes at each span's entry and exit, and the
step keeps the capture map (``Step.map``): for each node, in the order a
replay runs them, the spans that were open when it was made.
"""
from __future__ import annotations

import gc
import math
import time
from collections import Counter
from typing import Callable

import numpy as np
import torch

from repro_torch import kernels, trace

__all__ = ["Step", "StepGraphs", "rows_step", "slot_index"]


_SIDE: dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every warm-up run on ``device`` uses. cuBLAS keeps a
    workspace for each stream it has run on until the process ends, so a
    new stream per capture would hold one more workspace per bucket step."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


class Step:
    """One bucket's step: ``fn(**inputs)`` on static int64 input tensors.

    ``inputs`` maps each input's name to its shape; all of them are views
    of one device buffer, so :meth:`load` is one host-to-device copy.
    ``fill`` gives an input a constant starting value (0 otherwise): the
    warm-up run and the capture see those values.
    """

    def __init__(self, fn: Callable, inputs: dict[str, tuple[int, ...]],
                 device: torch.device, fill: dict[str, int] | None = None):
        sizes = [math.prod(shape) for shape in inputs.values()]
        self.fn = fn
        self.buf = torch.zeros(sum(sizes), dtype=torch.long, device=device)
        self._host = np.zeros(sum(sizes), np.int64)
        self.inputs: dict[str, torch.Tensor] = {}
        self._spans: dict[str, slice] = {}
        offset = 0
        for (name, shape), n in zip(inputs.items(), sizes):
            self._spans[name] = slice(offset, offset + n)
            self.inputs[name] = self.buf[offset:offset + n].view(shape)
            offset += n
        for name, value in (fill or {}).items():
            self.inputs[name].fill_(value)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.counts: Counter = Counter()    # launches per replay, from the capture
        self.map: tuple | None = None       # the capture map (trace.node_map)
        self.map_seconds = 0.0              # the capture's time spent counting nodes

    def load(self, **arrays) -> None:
        """Set every input from host arrays of its shape, in one copy."""
        if arrays.keys() != self._spans.keys():
            raise ValueError(f"Step.load: inputs {sorted(arrays)} != {sorted(self._spans)}")
        for name, a in arrays.items():
            self._host[self._spans[name]] = np.asarray(a).reshape(-1)
        self.buf.copy_(torch.from_numpy(self._host))

    def __call__(self):
        """Run the step on the current inputs: replay its graph, or call fn."""
        if self.graph is None:
            return self.fn(**self.inputs)
        self.graph.replay()
        kernels.add_launches(self.counts)
        return self.out

    def capture(self, pool) -> None:
        """Warm up on a side stream, then capture ``fn`` into a CUDA graph
        drawing its memory from ``pool``."""
        side = _side_stream(self.buf.device)
        side.wait_stream(torch.cuda.current_stream(self.buf.device))
        with torch.cuda.stream(side):
            self.fn(**self.inputs)
        torch.cuda.current_stream(self.buf.device).wait_stream(side)
        before = kernels.launch_state()
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: a dead engine left in a
        # reference cycle would destroy its graphs there, and destroying a
        # graph is not permitted while a stream captures (the capture fails).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool), trace.capture() as mapped:
                out = self.fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.counts = kernels.launch_state() - before
        kernels.add_launches(self.counts, -1)
        self.graph, self.out = graph, out
        self.map, self.map_seconds = mapped.map, mapped.seconds


class StepGraphs:
    """The bucket steps of one engine, by key, with their shared graph pool.

    ``enabled`` asks for graphs; they are used on a CUDA device only.
    ``seconds`` is the time spent making steps (warm-up runs and captures),
    ``map_seconds`` the part of it the captures spent counting nodes.
    """

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = bool(enabled) and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None
        self.steps: dict[tuple, Step] = {}
        self.seconds = 0.0

    def get(self, key: tuple, make: Callable[[], tuple]) -> Step:
        """The step of ``key``; a new one is made from ``make()`` -> (fn,
        inputs, fill), warmed up and, with graphs, captured."""
        step = self.steps.get(key)
        if step is None:
            t0 = time.perf_counter()
            fn, inputs, fill = make()
            step = Step(fn, inputs, self.device, fill)
            if self.enabled:
                step.capture(self.pool)
                torch.cuda.synchronize(self.device)
            else:
                step()
            self.steps[key] = step
            self.seconds += time.perf_counter() - t0
        return step

    @property
    def map_seconds(self) -> float:
        return sum(step.map_seconds for step in self.steps.values())

    @property
    def n_graphs(self) -> int:
        return sum(step.graph is not None for step in self.steps.values())

    def pool_bytes(self) -> int | None:
        """Device bytes the graph pool holds (its segments in the caching
        allocator's snapshot); 0 without graphs, None where the snapshot
        does not name segments' pools."""
        if not self.enabled:
            return 0
        segments = torch.cuda.memory_snapshot()
        if not segments or "segment_pool_id" not in segments[0]:
            return None
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == pool)


def slot_index(slots, batch: int, spare: int) -> tuple[np.ndarray, np.ndarray]:
    """(gather, scatter) slot indices of a micro-batch padded to ``batch``
    rows. Pad rows gather the last real slot, as the reference's do, and
    scatter into the ``spare`` slot, so no pad row writes a real slot and
    the scatter has the bucket's fixed shape."""
    slots = np.asarray(slots, np.int64)
    pad = batch - len(slots)
    return (np.concatenate([slots, np.full(pad, slots[-1], np.int64)]),
            np.concatenate([slots, np.full(pad, spare, np.int64)]))


def rows_step(step_fn, params, cache: dict):
    """A bucket step over slot-cache rows: gather the micro-batch's rows
    (``gidx``) of every cache entry (K/V, and the SSD state of the SSM and
    hybrid families), run ``step_fn(params, rows, tokens, index, [last])``
    on them (it writes the rows in place), scatter the rows back (``sidx``;
    pad rows into the spare slot). Returns (greedy tokens, logits)."""

    def run(tokens, index, gidx, sidx, last=None):
        with trace.span("rows.gather"):
            rows = {name: c.index_select(1, gidx) for name, c in cache.items()}
        extra = () if last is None else (last,)
        logits, rows = step_fn(params, rows, tokens, index, *extra)
        with trace.span("rows.scatter"):
            for name, c in cache.items():
                c.index_copy_(1, sidx, rows[name])
        with trace.span("rows.sample"):
            return logits.argmax(-1), logits

    return run
