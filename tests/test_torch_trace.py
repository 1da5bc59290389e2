"""The port's spans (``repro_torch.trace``) on the CPU.

With no profiler recording and no capture, a span is a flag check: it
enters no ``record_function`` and records nothing. Under ``torch.profiler``
the CPU engine's steps record every engine span, a queue span per admitted
request, and each planned product's ``falcon.leaf`` with the Decision
Module's price; the record's clock agrees with the profiler's trace. The
capture map (which nodes of a captured graph each span made) is checked
here with a stand-in for the driver's graph calls; the card's own capture
is checked by ``tests/test_torch_serve.py`` (``-m cuda``).
"""
import dataclasses
import json
import statistics
import time

import pytest
from torch.profiler import ProfilerActivity, profile

import repro_torch.api as tfalcon
import repro_torch.serve as tserve
from repro_torch import trace
from repro_torch.configs import lcma_smoke_config
from repro_torch.core import decision as dec, hardware as thw, plan_cache as tcache
from repro_torch.core.falcon_gemm import FalconConfig, plan

# a profile under which LCMAs win at smoke shapes (tests/test_torch_serve_engine.py's)
PROFILE = dict(name="serve_parity_profile", flops_mul=2e12, flops_add=5e13,
               beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
               mxu_align=8, dtype_flops=None, lcma_gemm_efficiency=1.0)
CANDIDATES = ("strassen", "strassen-winograd", "s223")
ENGINE_SPANS = {"serve.step", "serve.schedule", "serve.inputs", "serve.launch",
                "serve.readback", "serve.emit"}
MODEL_SPANS = {"rows.gather", "rows.scatter", "rows.sample", "model.embed", "model.norm",
               "model.qkv", "model.attention", "model.out_proj", "model.mlp",
               "model.lm_head", "falcon.leaf"}


@pytest.fixture(autouse=True)
def _clean():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def lcma_profile():
    """The parity profile registered, the plan cache emptied (restored)."""
    thw.register_profile(thw.HardwareProfile(**PROFILE))
    tcache.reset()
    yield FalconConfig(hardware=PROFILE["name"], candidates=CANDIDATES)
    tcache.reset()


def _engine(fcfg, slots=2):
    with tfalcon.use(fcfg):
        engine = tserve.ServeEngine(lcma_smoke_config("granite_3_2b"), max_slots=slots,
                                    max_prompt_len=16, max_new_tokens=3, device="cpu", seed=0)
    engine.warm()
    return engine


def test_without_a_profiler_a_span_is_a_flag_check(monkeypatch, lcma_profile):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(trace._profiler, "record_function", refuse)
    assert trace.span("serve.step") is trace.span("model.mlp", rows=4)   # one shared no-op
    assert trace.span_with("falcon.leaf", refuse) is trace.span("x")    # attrs never computed
    trace.event("serve.queue", 0.0, 1.0, rid=0)
    engine = _engine(lcma_profile)
    engine.submit(list(range(1, 9)), max_new_tokens=2)
    engine.run()
    assert trace.records() == []


def test_engine_steps_record_their_spans_queue_waits_and_leaf_prices(lcma_profile):
    engine = _engine(lcma_profile)
    reqs = [engine.submit(list(range(1, 6 + i)), max_new_tokens=3) for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]):
        steps = 0
        while engine.step():
            steps += 1
    recs = trace.records()
    names = {r.name for r in recs}
    assert ENGINE_SPANS | MODEL_SPANS <= names
    assert sum(r.name == "serve.step" for r in recs) == steps + 1   # the last found no work
    assert sum(r.name == "serve.launch" for r in recs) == steps
    # one queue span a request, from its submit to its admission
    queue = {r.attrs["rid"]: r for r in recs if r.name == "serve.queue"}
    assert sorted(queue) == sorted(r.rid for r in reqs)
    for r in reqs:
        assert queue[r.rid].t0 == r.submit_t and queue[r.rid].t1 == r.admit_t >= r.submit_t
    # the third request waited for a slot: admitted after a request finished
    assert reqs[2].admit_t > min(r.finish_t for r in reqs[:2])
    # spans nest: each launch inside a step, each leaf inside a model span
    assert all(r.parent == "serve.step" for r in recs if r.name == "serve.launch")
    leaves = [r for r in recs if r.name == "falcon.leaf"]
    assert {r.parent for r in leaves} <= MODEL_SPANS
    # each leaf carries the price its decision gave
    lcma = [r for r in leaves if r.attrs["path"] != "gemm"]
    assert lcma and any(r.attrs["path"] == "gemm" for r in leaves)
    dt = str(engine.cfg.dtype)
    for r in leaves:
        a = r.attrs
        if "B" in a:
            continue
        assert a["gemm_seconds"] == dec.gemm_time(a["M"], a["N"], a["K"], PROFILE["name"], dt)
        if a["path"] != "gemm":
            d = plan(a["M"], a["K"], a["N"],
                     dataclasses.replace(engine.fcfg, candidates=(a["path"],)), dt,
                     precombined_b=True)
            assert d.use_lcma and a["seconds"] == d.lcma_seconds
        else:
            assert a["seconds"] == a["gemm_seconds"]


def test_record_times_match_the_profilers_trace(tmp_path):
    names = [f"probe.{i}" for i in range(6)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with trace.span(name):
                with trace.span(name + ".inner"):
                    time.sleep(0.002)
                time.sleep(0.001)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    recs = {r.name: r for r in trace.records()}
    assert recs["probe.3.inner"].parent == "probe.3" and recs["probe.3"].parent is None
    # one offset, from the spans after the first (a profiler's first span lags)
    offset = statistics.median(events[n]["ts"] - r.t0 * 1e6 for n, r in recs.items()
                               if not n.startswith("probe.0"))
    for name, r in recs.items():
        if name.startswith("probe.0"):
            continue
        e = events[name]
        assert abs(e["ts"] - (r.t0 * 1e6 + offset)) < 100, name
        assert abs(e["ts"] + e["dur"] - (r.t1 * 1e6 + offset)) < 100, name


class FakeNodes:
    """A graph being captured, for ``trace.capture``: ``add(kind)`` makes
    a node (None: one that is no device operation)."""

    def __init__(self, chain=True):
        self.kinds, self.chain = [], chain

    def add(self, kind="kernel"):
        self.kinds.append(kind)

    def tip(self):
        return len(self.kinds)

    def finish(self, tips):
        return (self.kinds, tips) if self.chain else None


def test_capture_map_gives_each_node_the_spans_open_when_it_was_made():
    nodes = FakeNodes()
    with trace.span("outside"):              # open before the capture: not in the map
        with trace.capture(nodes) as cap:
            assert trace.span("a") is not trace.span("b")    # read while capturing
            nodes.add()                          # under no span of the capture
            with trace.span("model.qkv", layer=0):
                nodes.add()
                with trace.span("falcon.leaf", M=8):
                    nodes.add()
                    nodes.add(None)              # an empty node: no device work
                    nodes.add("memcpy")
                with trace.span("model.norm"):
                    pass                         # a span that made no node
                nodes.add("memset")
            nodes.add()
    assert trace.span("a") is trace.span("b") and trace.records() == []
    got = [(kind, [f.name for f in stack]) for kind, stack in cap.map]
    assert got == [("kernel", []), ("kernel", ["model.qkv"]),
                   ("kernel", ["model.qkv", "falcon.leaf"]),
                   ("memcpy", ["model.qkv", "falcon.leaf"]),
                   ("memset", ["model.qkv"]), ("kernel", [])]
    assert cap.map[1][1][0].attrs == {"layer": 0}
    # one span instance, one frame; two instances of a name, two frames
    assert cap.map[2][1][1] is cap.map[3][1][1] and cap.map[1][1][0] is cap.map[4][1][0]
    assert cap.seconds >= 0


def test_capture_map_is_none_where_the_graph_is_not_one_chain():
    nodes = FakeNodes(chain=False)
    with trace.capture(nodes) as cap:
        with trace.span("model.mlp"):
            nodes.add()
    assert cap.map is None


@pytest.mark.parametrize("marks, kinds, want", [
    ([], ["kernel", "kernel"], [("kernel", ()), ("kernel", ())]),
    ([(0, "a"), (1, None), (1, "b"), (3, None)], ["kernel", "memcpy", "kernel"],
     [("kernel", ("a",)), ("memcpy", ("b",)), ("kernel", ("b",))]),
    ([(0, "a"), (0, "b"), (2, None), (3, None)], ["kernel", None, "kernel", "kernel"],
     [("kernel", ("a", "b")), ("kernel", ("a",)), ("kernel", ())]),
])
def test_node_map_from_counts(marks, kinds, want):
    got = trace.node_map([(n, None if f is None else trace.Frame(f, {})) for n, f in marks],
                         kinds)
    assert [(k, tuple(f.name for f in stack)) for k, stack in got] == want
