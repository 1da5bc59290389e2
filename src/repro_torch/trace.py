"""Spans of the port's host code: a serving step and its phases, a layer of
the model, one planned product (a *leaf*).

``span(name, **attrs)`` is a context manager around such a stretch. It
costs one flag check unless something reads it:

* **a torch profiler records**: the span enters
  ``torch.profiler.record_function(name)``, so it lands in the profiler's
  trace on the clock of the device operations it launched, and on exit a
  :class:`SpanRec` (name, attrs, the enclosing span's name, start and end on
  ``time.perf_counter``) joins :data:`RECORD`, a bounded in-memory record;
  :func:`event` adds a span measured elsewhere (a request's queue wait);
* **a CUDA graph is captured under** :func:`capture`: the span notes, at
  its entry and exit, the last node of the graph being captured, read from
  the capture itself through the driver (``cuStreamGetCaptureInfo``); at
  the capture's end ``cuGraphGetNodes`` turns each note into how many nodes
  had been made, and :func:`node_map` turns those counts into the capture
  map: for each device-operation node (kernel, copy, set) of the graph, in
  capture order, the stack of spans open when it was made. One stream's
  capture is a chain, so a replay runs its nodes in that order.

A replay runs no Python, so no span runs inside it: the capture map names
the work of each replay.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import threading
import time
from typing import Callable, NamedTuple

import torch.autograd.profiler as _profiler

__all__ = ["Frame", "SpanRec", "span", "span_with", "event", "records", "clear",
           "GraphNodes", "capture", "node_map"]

RECORD_LEN = 1 << 16


@dataclasses.dataclass(frozen=True, eq=False)
class Frame:
    """One span as a capture saw it open. Frames compare by identity: one
    span entered twice gives two frames."""
    name: str
    attrs: dict


class SpanRec(NamedTuple):
    """One finished span while a profiler recorded: times on
    ``time.perf_counter``; ``parent`` the enclosing span's name."""
    name: str
    attrs: dict
    parent: str | None
    t0: float
    t1: float


RECORD: collections.deque = collections.deque(maxlen=RECORD_LEN)
_CAPTURE = None                     # the _Capture in progress, or None
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "rf", "t0", "parent", "cap")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.rf = self.cap = None

    def __enter__(self):
        st = _stack()
        if _CAPTURE is not None:
            self.cap = _CAPTURE
            self.cap.enter(Frame(self.name, self.attrs))
        if _profiler._is_profiler_enabled:
            self.parent = st[-1].name if st else None
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
            self.t0 = time.perf_counter()
        st.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            t1 = time.perf_counter()
            RECORD.append(SpanRec(self.name, self.attrs, self.parent, self.t0, t1))
        if self.cap is not None:
            self.cap.exit()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span of host code named ``name``; ``attrs`` go with it into the
    record and the capture map."""
    if _CAPTURE is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def span_with(name: str, attrs: Callable[[], dict]):
    """``span(name, **attrs())``, calling ``attrs`` only where the span is
    read."""
    if _CAPTURE is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs())


def event(name: str, t0: float, t1: float, **attrs) -> None:
    """Record a span measured elsewhere, from ``t0`` to ``t1`` on
    ``time.perf_counter``, while a profiler records."""
    if _profiler._is_profiler_enabled:
        RECORD.append(SpanRec(name, attrs, None, t0, t1))


def records() -> list:
    """The record, oldest first."""
    return list(RECORD)


def clear() -> None:
    RECORD.clear()


# ---------------------------------------------------------------------------
# Capture maps
# ---------------------------------------------------------------------------

# CUgraphNodeType values of the device operations a replay runs
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1             # CU_STREAM_CAPTURE_STATUS_ACTIVE
_DRIVER = None


class _Driver:
    """The driver's graph calls, through ctypes on ``libcuda.so.1``, by the
    names a program built with CUDA 12 links (drivers keep them)."""

    P, SZ = ctypes.c_void_p, ctypes.c_size_t
    SIGNATURES = {
        "cuStreamGetCaptureInfo_v2": [P, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(P),
                                      ctypes.POINTER(ctypes.POINTER(P)), ctypes.POINTER(SZ)],
        "cuGraphGetNodes": [P, ctypes.POINTER(P), ctypes.POINTER(SZ)],
        "cuGraphNodeGetType": [P, ctypes.POINTER(ctypes.c_int)],
        "cuGraphGetEdges": [P, ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(SZ)],
    }

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        for name, args in self.SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            setattr(self, name.removesuffix("_v2"), fn)

    @staticmethod
    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")


def _driver() -> _Driver:
    global _DRIVER
    if _DRIVER is None:
        _DRIVER = _Driver()
    return _DRIVER


class GraphNodes:
    """The graph that ``stream`` (a ``cudaStream_t`` as an int) is
    capturing. ``tip()``: the node the stream's next operation will follow
    (0 before the first, -1 where it follows several), in constant time;
    ``finish(tips)``: each node's kind (None for a node that is no device
    operation) in capture order, and how many nodes each tip had made;
    None where the graph is not one chain in the order the driver lists
    its nodes."""

    def __init__(self, stream: int):
        self.drv, self.stream = _driver(), stream
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        self.drv.check(self.drv.cuStreamGetCaptureInfo(stream, ctypes.byref(status), None,
                                                       ctypes.byref(graph), None, None),
                       "cuStreamGetCaptureInfo")
        if status.value != _CAPTURE_ACTIVE:
            raise RuntimeError("the stream is not capturing a graph")
        self.graph = graph

    def tip(self) -> int:
        status, deps, n = ctypes.c_int(), ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
        self.drv.check(self.drv.cuStreamGetCaptureInfo(self.stream, ctypes.byref(status), None,
                                                       None, ctypes.byref(deps), ctypes.byref(n)),
                       "cuStreamGetCaptureInfo")
        return 0 if n.value == 0 else deps[0] if n.value == 1 else -1

    def finish(self, tips: list) -> tuple[list, list] | None:
        drv, n = self.drv, ctypes.c_size_t()
        drv.check(drv.cuGraphGetNodes(self.graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        drv.check(drv.cuGraphGetNodes(self.graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        m = ctypes.c_size_t()
        drv.check(drv.cuGraphGetEdges(self.graph, None, None, ctypes.byref(m)), "cuGraphGetEdges")
        src, dst = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
        drv.check(drv.cuGraphGetEdges(self.graph, src, dst, ctypes.byref(m)), "cuGraphGetEdges")
        order = list(nodes)
        if sorted(zip(src, dst)) != sorted(zip(order, order[1:])):
            return None
        made = {node: i + 1 for i, node in enumerate(order)}
        made[0] = 0
        if any(t not in made for t in tips):
            return None
        kinds, t = [], ctypes.c_int()
        for node in order:
            drv.check(drv.cuGraphNodeGetType(node, ctypes.byref(t)), "cuGraphNodeGetType")
            kinds.append(_NODE_KINDS.get(t.value))
        return kinds, [made[t] for t in tips]


class _Capture:
    """The tips of one capture at each span's entry and exit."""

    def __init__(self, nodes):
        self.nodes = nodes
        self.marks: list = []           # (tip, Frame entered or None on exit)
        self.map = None
        self.seconds = 0.0

    def enter(self, frame: Frame) -> None:
        t = time.perf_counter()
        self.marks.append((self.nodes.tip(), frame))
        self.seconds += time.perf_counter() - t

    def exit(self) -> None:
        t = time.perf_counter()
        self.marks.append((self.nodes.tip(), None))
        self.seconds += time.perf_counter() - t


def node_map(marks: list, kinds: list) -> tuple:
    """The capture map: for each device-operation node (``kinds[i]`` not
    None), in capture order, ``(kind, stack)`` with ``stack`` the tuple of
    frames open when it was made. ``marks``: (nodes made so far, the Frame
    entered, or None where the innermost span exited), in order."""
    out, stack, done = [], (), 0
    for n, frame in list(marks) + [(len(kinds), None)]:
        out.extend((k, stack) for k in kinds[done:n] if k is not None)
        done = max(done, n)
        if frame is not None:
            stack = stack + (frame,)
        elif stack:
            stack = stack[:-1]
    return tuple(out)


@contextlib.contextmanager
def capture(nodes=None):
    """Map the spans of the graph the current stream captures (or of
    ``nodes``, an object with ``tip()`` and ``finish(tips)`` as
    :class:`GraphNodes` has them). Enter it inside
    the capture; it yields a handle whose ``map`` is the capture map once
    the block ends (None where the driver's graph calls are missing or the
    graph is not one chain) and ``seconds`` the time the counting took."""
    global _CAPTURE
    if nodes is None:
        import torch
        t = time.perf_counter()
        try:
            nodes = GraphNodes(torch.cuda.current_stream().cuda_stream)
        except (OSError, AttributeError, RuntimeError):
            nodes = None
        wait = time.perf_counter() - t
    else:
        wait = 0.0
    cap = _Capture(nodes)
    cap.seconds = wait
    if nodes is None:
        yield cap
        return
    outer, _CAPTURE = _CAPTURE, cap
    try:
        yield cap
        t = time.perf_counter()
        done = nodes.finish([tip for tip, _ in cap.marks])
        if done is not None:
            kinds, made = done
            cap.map = node_map(list(zip(made, (f for _, f in cap.marks))), kinds)
        cap.seconds += time.perf_counter() - t
    finally:
        _CAPTURE = outer
