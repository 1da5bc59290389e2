"""The port's continuous-batching engine against the reference's, on the CPU.

Framework-free parts (buckets, the request queue, the scheduler, the stats
surface, the radix prefix cache) get the same inputs in both packages and
must give the same outputs: each case of ``tests/test_serve_engine.py`` and
``tests/test_serve_spec.py`` is one parametrised scenario run on both. The
registry resolution and ``warm_buckets`` must make the reference's plans.
Then both engines serve the same 8 ragged requests on the same weights
(``lcma_smoke_config("granite_3_2b")``, forced strassen; the reference on
``pallas_interpret``, the port through its kernels' plain versions): tokens
equal, logits within 1e-4 in f32 (as ``tests/test_torch_model.py``), and
the ``summary()`` counts equal. Serving after ``warm()`` adds no plan-cache
miss. The MoE family likewise: ``smoke_config("dbrx_132b")`` (4 experts,
top-2; the reference on its ``"jnp"`` backend) token-exact with and
without speculation, its warm plans the reference's, and warm covering
every key a serve run touches, the grouped expert FFN's among them.
"""
import dataclasses
import random
import threading
import types

import jax
import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.api as tfalcon
import repro_torch.serve as tserve
from repro.configs.registry import lcma_smoke_config as j_lcma, smoke_config as j_smoke
from repro.core import engine as jengine, hardware as jhw, plan_cache as jcache
from repro.core import workloads as jworkloads
from repro.core.falcon_gemm import FalconConfig as JConfig
from repro.models import model as JM
from repro_torch.configs import lcma_smoke_config as t_lcma, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as tengine, hardware as thw, plan_cache as tcache
from repro_torch.core import workloads as tworkloads
from repro_torch.core.falcon_gemm import FalconConfig as TConfig

PROMPT_LENS = (3, 8, 11, 16)
TOL = dict(rtol=1e-4, atol=1e-4)
# a profile under which LCMAs win at smoke shapes, given to both packages
# (as in tests/test_torch_model.py)
PROFILE = dict(name="serve_parity_profile", flops_mul=2e12, flops_add=5e13,
               beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
               mxu_align=8, dtype_flops=None, lcma_gemm_efficiency=1.0)
CANDIDATES = ("strassen", "strassen-winograd", "s223")


# ---------------------------------------------------------------------------
# Framework-free parts: one scenario, both packages, equal outputs
# ---------------------------------------------------------------------------

def _work(w):
    """A scheduler work item as plain data."""
    if w is None:
        return None
    out = (type(w).__name__, tuple(r.prompt_len for r in w.requests), w.slots,
           w.batch_pad, w.real_tokens, w.padded_tokens)
    if type(w).__name__ == "PrefillWork":
        out += (w.seq_pad, w.starts, w.lengths, w.final)
    return out


def _raises(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", type(e).__name__)


def sc_next_pow2(S):
    return [S.next_pow2(n) for n in (1, 2, 3, 5, 8, 9, 31)] + [_raises(lambda: S.next_pow2(0))]


def sc_bucket_grid(S):
    p = S.BucketPolicy.build(max_prompt_len=24, max_slots=4, min_seq=8)
    return (p.prefill_seq, p.prefill_batch, p.decode_batch, p.seq_bucket(3),
            p.seq_bucket(17), p.decode_batch_bucket(3), p.bucket_ms(),
            p.prefill_shapes(), _raises(lambda: p.seq_bucket(33)))


def sc_verify_bucket_monotone(S):
    policy = S.BucketPolicy.build(max_prompt_len=16, max_slots=8, min_seq=8)
    return [[policy.decode_batch_bucket(b), (policy.decode_batch_bucket(b), g + 1)]
            for b in range(1, 9) for g in range(1, 5)]


def sc_request_queue(S):
    q = S.RequestQueue()
    reqs = [S.Request(prompt=[1, 2, i + 3], max_new_tokens=2) for i in range(16)]
    threads = [threading.Thread(target=q.submit, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    head = q.peek(4)
    q.pop(head[:2])
    after = q.peek(1)[0] is head[2]
    return (len(reqs), len(head), len(q), after,
            _raises(lambda: S.Request(prompt=[])),
            _raises(lambda: S.Request(prompt=[1], max_new_tokens=0)),
            S.Request(prompt=[4, 5], max_new_tokens=3).tokens)


def _sched(S, max_slots=4, max_prompt_len=16, cap=0, chunk=None):
    q = S.RequestQueue()
    policy = S.BucketPolicy.build(max_prompt_len=max_prompt_len, max_slots=max_slots,
                                  min_seq=8)
    return q, S.Scheduler(q, policy, max_slots=max_slots, max_consecutive_prefills=cap,
                          prefill_chunk=chunk)


def sc_scheduler_groups(S):
    q, s = _sched(S)
    for plen in (5, 7, 16, 6):
        q.submit(S.Request(prompt=list(range(1, plen + 1)), max_new_tokens=2))
    works = [s.next_work() for _ in range(4)]
    s.release(works[0].requests[0])
    return [_work(w) for w in works] + [s.n_free, s.n_active]


def sc_slot_exhaustion(S):
    q, s = _sched(S, max_slots=1)
    q.submit(S.Request(prompt=[1, 2], max_new_tokens=2))
    q.submit(S.Request(prompt=[3, 4], max_new_tokens=2))
    return [_work(s.next_work()), _work(s.next_work()), len(q)]


def sc_chunk_geometry(S):
    q, s = _sched(S, max_slots=2, max_prompt_len=32, chunk=8)
    q.submit(S.Request(prompt=list(range(1, 21)), max_new_tokens=2))
    return [_work(s.next_work()) for _ in range(4)] + [
        _raises(lambda: _sched(S, chunk=12)), _sched(S, chunk=8)[1].prefill_chunk]


def sc_fairness_cap(S):
    """Continuous arrivals with instantaneous steps (tests/test_serve_spec.py's
    ``_drive_scheduler``): the P/D sequence with the cap and without it."""
    def drive(cap, steps=60):
        q, s = _sched(S, max_slots=8, cap=cap)
        rng = np.random.default_rng(0)

        def arrive(n):
            for _ in range(n):
                plen = int(rng.choice([5, 16]))
                q.submit(S.Request(prompt=list(range(1, plen + 1)), max_new_tokens=4))

        arrive(16)
        trace = []
        for _ in range(steps):
            work = s.next_work()
            if work is None:
                arrive(4)
                continue
            trace.append("P" if type(work).__name__ == "PrefillWork" else "D")
            if trace[-1] == "D":
                for r in work.requests:
                    r.generated.append(0)
                    if len(r.generated) >= r.max_new_tokens:
                        r.state = "done"
                        s.release(r)
                arrive(2)
        return "".join(trace)
    return drive(2), drive(0)


def sc_stats(S):
    s = S.ServeStats()
    zero = s.as_dict()
    for i, f in enumerate(("prefill_steps", "decode_steps", "verify_steps", "prompt_tokens",
                           "generated_tokens", "decode_real_rows", "decode_emitted_tokens",
                           "prefill_padded_tokens", "decode_padded_tokens", "drafted_tokens",
                           "accepted_tokens", "prefix_hits", "prefix_misses", "bucket_hits",
                           "bucket_misses")):
        setattr(s, f, 3 + 2 * i)
    s.t_prefill, s.t_decode = 0.5, 1.5
    return sorted(zero.items()), sorted(s.as_dict().items())


def sc_radix_longest_prefix(S):
    out = []
    for seed in range(8):
        rnd = random.Random(seed)
        cache = S.RadixPrefixCache(max_entries=64)
        for i in range(30):
            cache.insert(tuple(rnd.randrange(4) for _ in range(rnd.randint(1, 12))), {"id": i})
        for _ in range(30):
            n, e = cache.lookup(tuple(rnd.randrange(4) for _ in range(rnd.randint(1, 14))))
            out.append((n, None if e is None else e.payload["id"]))
        out.append(cache.stats())
    return out


def sc_radix_capacity_pinned(S):
    out = []
    for seed, max_entries in ((0, 1), (1, 3), (2, 8)):
        rnd = random.Random(seed)
        cache = S.RadixPrefixCache(max_entries=max_entries)
        pinned = tuple(rnd.randrange(4) for _ in range(6))
        cache.insert(pinned, {"pinned": True})
        n, entry = cache.lookup(pinned, pin=True)
        for i in range(4 * max_entries):
            toks = tuple(rnd.randrange(4) for _ in range(rnd.randint(1, 10)))
            if toks != pinned:
                cache.insert(toks, {"i": i})
            m, e = cache.lookup(pinned)
            out.append((m, e is entry, cache.stats()))
        cache.release(entry)
        out.append(cache.stats())
    return out


def sc_radix_lru_and_split(S):
    cache = S.RadixPrefixCache(max_entries=2)
    cache.insert((1, 2, 3), {"a": 1})
    cache.insert((1, 2, 4), {"b": 2})
    cache.lookup((1, 2, 3))
    cache.insert((5, 6), {"c": 3})
    lru = (cache.lookup((1, 2, 3))[0], cache.lookup((1, 2, 4)), cache.stats())
    cache = S.RadixPrefixCache(max_entries=8)
    cache.insert((7, 8, 9, 10), {"long": 1})
    cache.insert((7, 8), {"short": 1})
    n1, e1 = cache.lookup((7, 8, 9, 10, 11))
    n2, e2 = cache.lookup((7, 8, 9))
    return lru, (n1, e1.payload), (n2, e2.payload), _raises(lambda: cache.insert((), {}))


SCENARIOS = [sc_next_pow2, sc_bucket_grid, sc_verify_bucket_monotone, sc_request_queue,
             sc_scheduler_groups, sc_slot_exhaustion, sc_chunk_geometry, sc_fairness_cap,
             sc_stats, sc_radix_longest_prefix, sc_radix_capacity_pinned,
             sc_radix_lru_and_split]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_framework_free_parts_match_reference(scenario):
    assert scenario(tserve) == scenario(jserve)


def test_serve_stats_keys_match_reference():
    assert set(tserve.ServeStats().as_dict()) == set(jserve.ServeStats().as_dict())


# ---------------------------------------------------------------------------
# Registry resolution and warm_buckets: the reference's plans
# ---------------------------------------------------------------------------

CONTEXTS = [dict(batch=2, seq=16), dict(batch=1, seq=600),
            dict(batch=4, seq=8, kv_len=32), dict(batch=2, seq=1, kv_len=32, decode=True),
            dict(batch=2, seq=3, kv_len=32, spec_verify=True)]


@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_resolve_contractions_match_reference(ctx):
    want = [(c.kind, c.role, c.key_shape(), c.weight_static)
            for c in jworkloads.resolve_contractions(j_lcma("granite_3_2b"), **ctx)]
    got = [(c.kind, c.role, c.key_shape(), c.weight_static)
           for c in tworkloads.resolve_contractions(t_lcma("granite_3_2b"), **ctx)]
    assert got == want and got


@pytest.fixture
def parity_profile():
    """Both packages' process-global plan caches, emptied, and the parity
    profile registered in both; restored after."""
    jhw.register_profile(jhw.HardwareProfile(**PROFILE))
    thw.register_profile(thw.HardwareProfile(**PROFILE))
    jcache.reset()
    tcache.reset()
    yield
    jcache.reset()
    tcache.reset()


@pytest.mark.parametrize("case", ["flat", "grid", "grid_spec", "grid_quant"])
def test_warm_buckets_makes_the_reference_plans(case, parity_profile):
    buckets = [1, 2, 4, 64, 128] if case == "flat" else \
        [(b, s) for b in (1, 2) for s in (8, 16)] + [(1, 1), (2, 1)]
    kw = {} if case == "flat" else dict(kv_len=32)
    if case == "grid_spec":
        kw["spec_gamma"] = 2
    quant = case == "grid_quant"
    jn = jengine.warm_buckets(JConfig(hardware=PROFILE["name"], candidates=CANDIDATES,
                                      quantize=quant), j_lcma("granite_3_2b"), buckets,
                              dtype="float32", **kw)
    tn = tengine.warm_buckets(TConfig(hardware=PROFILE["name"], candidates=CANDIDATES,
                                      quantize=quant), t_lcma("granite_3_2b"), buckets,
                              dtype="float32", **kw)
    assert tn == jn > 0
    # the keys less the profile's name and fingerprint (their first part)
    # and the reference's ``fused=`` token (the port's pipeline is always
    # the fused one, and its keys carry no such token)
    keys = lambda c: sorted("|".join(p for p in k.split("|")[1:]  # noqa: E731
                                     if not p.startswith("fused="))
                            for k in c.default_cache().keys())
    assert keys(tcache) == keys(jcache)
    assert tcache.stats().misses == jcache.stats().misses == len(tcache.default_cache())


# ---------------------------------------------------------------------------
# The two engines on the same weights and requests
# ---------------------------------------------------------------------------

def _requests(vocab: int):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, int(PROMPT_LENS[i % len(PROMPT_LENS)])),
             int(rng.integers(1, 5))) for i in range(8)]


def _serve(engine, reqs):
    warm = engine.warm()
    out = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    engine.run()
    return warm, out


COUNTS = ("prefill_steps", "decode_steps", "verify_steps", "prompt_tokens",
          "generated_tokens", "decode_real_rows", "decode_emitted_tokens",
          "prefill_padded_tokens", "decode_padded_tokens", "bucket_hits", "bucket_misses",
          "warmed_shapes", "warm_plans", "requests_admitted", "requests_finished",
          "padding_waste", "bucket_hit_rate", "precombined_weights", "max_len", "max_slots")


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(j_lcma("granite_3_2b"), falcon_mode="strassen",
                               falcon_backend="pallas_interpret")
    tcfg = dataclasses.replace(t_lcma("granite_3_2b"), falcon_mode="strassen")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    reqs = _requests(jcfg.vocab_size)
    kw = dict(max_slots=2, max_prompt_len=16, max_new_tokens=4, record_logits=True)
    jcache.reset()
    jeng = jserve.ServeEngine(jcfg, jax.tree.map(jax.numpy.asarray, np_params), **kw)
    jwarm, jout = _serve(jeng, reqs)
    tcache.reset()
    teng = tserve.ServeEngine(tcfg, params_from_numpy(np_params, tcfg, device="cpu"),
                              device="cpu", **kw)
    twarm, tout = _serve(teng, reqs)
    return (jeng, jwarm, jout), (teng, twarm, tout)


def test_engine_tokens_and_logits_match_reference(engines):
    (_, _, jout), (_, _, tout) = engines
    for j, t in zip(jout, tout):
        assert t.done and t.generated == j.generated, (t.rid, t.generated, j.generated)
        assert len(t.logits) == len(j.logits) == len(t.generated)
        for step, (got, want) in enumerate(zip(t.logits, j.logits)):
            np.testing.assert_allclose(got, want, err_msg=f"request {t.rid} step {step}",
                                       **TOL)


def test_engine_summary_counts_match_reference(engines):
    (jeng, jwarm, _), (teng, twarm, _) = engines
    js, ts = jeng.summary(), teng.summary()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert (twarm["plans"], twarm["shapes"]) == (jwarm["plans"], jwarm["shapes"]) == \
        (ts["warm_plans"], 6)
    assert ts["precombined_weights"] == 7 and ts["bucket_misses"] == 0
    assert ts["cuda_graphs"] is False and ts["graphs"] == 0     # the CPU runs eagerly


def test_engine_adds_no_plan_miss_after_warm(parity_profile):
    """Auto mode on a profile where LCMAs win (the ambient config), so the
    planned leaves' re-decision at each bucket M (candidates restricted to
    the leaf's scheme) runs: every plan serving asks for was planned by
    warm()."""
    cfg = t_lcma("granite_3_2b")
    with tfalcon.use(TConfig(hardware=PROFILE["name"], candidates=CANDIDATES)):
        engine = tserve.ServeEngine(cfg, max_slots=2, max_prompt_len=16, max_new_tokens=4,
                                    device="cpu", seed=0)
    assert engine.n_precombined > 0 and engine.fcfg.hardware == PROFILE["name"]
    engine.warm()
    keys_warm = set(tcache.default_cache().keys())
    misses = tcache.stats().misses
    for prompt, n in _requests(cfg.vocab_size):
        engine.submit(prompt, max_new_tokens=n)
    assert len(engine.run()) == 8
    assert tcache.stats().misses == misses and tcache.stats().hits > 0
    assert set(tcache.default_cache().keys()) == keys_warm
    assert engine.summary()["bucket_misses"] == 0


def test_engine_validates_like_the_reference():
    cfg = t_smoke("granite_3_2b")
    engine = tserve.ServeEngine(cfg, max_slots=2, max_prompt_len=8, max_new_tokens=2,
                                device="cpu")
    with pytest.raises(ValueError):
        engine.submit(list(range(9)))            # prompt off the bucket grid
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=3)  # exceeds engine cap
    # a mesh serves only on its ranks (tests/test_torch_mesh.py,
    # tests/test_torch_serve_data.py), over either axis
    with pytest.raises(RuntimeError, match="belongs to no mesh"):
        tserve.ServeEngine(cfg, device="cpu", mesh_shape={"data": 1, "model": 2})
    with pytest.raises(RuntimeError, match="belongs to no mesh"):
        tserve.ServeEngine(cfg, device="cpu", mesh_shape={"data": 2, "model": 1})
    with pytest.raises(NotImplementedError, match="frontend"):
        tserve.ServeEngine(types.SimpleNamespace(frontend="vision_patches"), device="cpu")
    # prefix snapshots take K/V and the recurrent SSM state, nothing else
    cache = {"k": None, "v": None, "state": None}
    assert tserve.prefix_cache.check_kv_cache(cache) is cache
    with pytest.raises(ValueError, match="also holds"):
        tserve.prefix_cache.check_kv_cache({"k": None, "conv": None})


# ---------------------------------------------------------------------------
# The MoE family: dbrx's smoke config in both engines
# ---------------------------------------------------------------------------

MOE_KW = dict(max_slots=2, max_prompt_len=16, max_new_tokens=4, record_logits=True)


def _moe_configs(mode: str):
    return (dataclasses.replace(j_smoke("dbrx_132b"), falcon_mode=mode, falcon_backend="jnp"),
            dataclasses.replace(t_smoke("dbrx_132b"), falcon_mode=mode))


@pytest.fixture(scope="module")
def moe_weights():
    jcfg, _ = _moe_configs("strassen")
    return jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def moe_engines(moe_weights):
    """Both engines serving the 8 ragged requests on dbrx's smoke config in
    forced strassen (the attention leaves precombined, the experts through
    the grouped LCMA at each bucket's capacity)."""
    jcfg, tcfg = _moe_configs("strassen")
    reqs = _requests(jcfg.vocab_size)
    jcache.reset()
    jeng = jserve.ServeEngine(jcfg, jax.tree.map(jax.numpy.asarray, moe_weights), **MOE_KW)
    jwarm, jout = _serve(jeng, reqs)
    tcache.reset()
    teng = tserve.ServeEngine(tcfg, params_from_numpy(moe_weights, tcfg, device="cpu"),
                              device="cpu", **MOE_KW)
    twarm, tout = _serve(teng, reqs)
    return (jeng, jwarm, jout), (teng, twarm, tout)


def test_moe_engine_tokens_and_logits_match_reference(moe_engines):
    (jeng, jwarm, jout), (teng, twarm, tout) = moe_engines
    for j, t in zip(jout, tout):
        assert t.done and t.generated == j.generated, (t.rid, t.generated, j.generated)
        for step, (got, want) in enumerate(zip(t.logits, j.logits)):
            np.testing.assert_allclose(got, want, err_msg=f"request {t.rid} step {step}",
                                       **TOL)
    js, ts = jeng.summary(), teng.summary()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert (twarm["plans"], twarm["shapes"]) == (jwarm["plans"], jwarm["shapes"])
    assert ts["precombined_weights"] == 4 and ts["bucket_misses"] == 0


@pytest.mark.parametrize("case", ["grid", "grid_spec"])
def test_moe_warm_buckets_makes_the_reference_plans(case, parity_profile):
    """dbrx's smoke config on a profile where LCMAs win: the grouped expert
    contractions at each bucket's capacity (plain and precombined) and the
    restricted re-decisions, key for key the reference's."""
    buckets = [(b, s) for b in (1, 2) for s in (8, 16)] + [(1, 1), (2, 1)]
    kw = dict(kv_len=32, spec_gamma=2 if case == "grid_spec" else None)
    jcfg, tcfg = _moe_configs("auto")
    jn = jengine.warm_buckets(JConfig(hardware=PROFILE["name"], candidates=CANDIDATES),
                              jcfg, buckets, dtype="float32", **kw)
    tn = tengine.warm_buckets(TConfig(hardware=PROFILE["name"], candidates=CANDIDATES),
                              tcfg, buckets, dtype="float32", **kw)
    assert tn == jn > 0
    keys = lambda c: sorted("|".join(p for p in k.split("|")[1:]  # noqa: E731
                                     if not p.startswith("fused="))
                            for k in c.default_cache().keys())
    assert keys(tcache) == keys(jcache)
    assert any("|g4x" in k for k in tcache.default_cache().keys())


def test_moe_warm_covers_every_serve_plan_key():
    """32 ragged requests on dbrx's smoke config in auto mode (the data
    sheet) touch only plan-cache keys ``warm()`` made: the grouped expert
    FFN's at every bucket's capacity among them (reference
    ``tests/test_serve_engine.py::test_warm_covers_all_serve_plan_keys``)."""
    _, cfg = _moe_configs("auto")
    tcache.reset()
    try:
        engine = tserve.ServeEngine(cfg, max_slots=4, max_prompt_len=16, max_new_tokens=4,
                                    device="cpu", seed=0)
        engine.warm()
        keys_warm = set(tcache.default_cache().keys())
        misses = tcache.stats().misses
        rng = np.random.default_rng(0)
        for plen in rng.integers(2, 16, size=32):
            engine.submit(list(rng.integers(0, cfg.vocab_size, int(plen))), max_new_tokens=4)
        assert len(engine.run()) == 32
        assert set(tcache.default_cache().keys()) == keys_warm
        assert tcache.stats().misses == misses
        assert any("|g4x" in k for k in keys_warm)
    finally:
        tcache.reset()


def test_moe_speculative_shrunk_draft_token_exact(moe_weights):
    """A 1-layer sliced draft of dbrx's smoke config mispredicts freely;
    greedy verify/rollback emits exactly the plain engine's tokens, which
    are the reference's, with the reference's acceptance counts (reference
    ``tests/test_serve_spec.py::test_speculative_shrunk_draft_token_exact``)."""
    jcfg, tcfg = _moe_configs("strassen")
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, tcfg.vocab_size, n)) for n in (6, 13, 4)]
    kw = dict(max_slots=2, max_prompt_len=16, max_new_tokens=6)
    spec = dict(speculate=2, draft_keep_layers=1)
    out = {}
    for name, extra in (("plain", {}), ("spec", spec)):
        tcache.reset()
        teng = tserve.ServeEngine(tcfg, params_from_numpy(moe_weights, tcfg, device="cpu"),
                                  device="cpu", seed=0, **kw, **extra)
        teng.warm()
        treqs = [teng.submit(p, max_new_tokens=6) for p in prompts]
        teng.run()
        jcache.reset()
        jeng = jserve.ServeEngine(jcfg, jax.tree.map(jax.numpy.asarray, moe_weights),
                                  **kw, **extra)
        jeng.warm()
        jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
        jeng.run()
        out[name] = (teng, [r.generated for r in treqs], jeng, [list(r.generated) for r in jreqs])
    assert out["spec"][1] == out["plain"][1] == out["plain"][3] == out["spec"][3]
    teng, jeng = out["spec"][0], out["spec"][2]
    assert teng.draft.keep_layers == 1 < tcfg.num_layers
    assert 0 < teng.stats.accepted_tokens < teng.stats.drafted_tokens
    assert (teng.stats.accepted_tokens, teng.stats.drafted_tokens) == \
        (jeng.stats.accepted_tokens, jeng.stats.drafted_tokens)


def test_speculation_is_for_the_rollback_free_families():
    """As in the reference, speculation needs a cache without recurrent
    state: the dense and MoE families take it, any other is refused."""
    cfg = dataclasses.replace(t_smoke("granite_3_2b"), family="ssm")
    with pytest.raises(ValueError, match="specul"):
        tserve.ServeEngine(cfg, device="cpu", speculate=2)
