"""Speculative decoding, prefix reuse, chunked prefill and streaming in the
port's engine, on the CPU.

The contract is *token-exactness*: every serving feature here (γ-token
speculation with greedy verify/rollback, radix prefix-KV reuse,
fixed-bucket chunked prefill, per-token streaming) must emit exactly the
tokens the port's plain engine emits, which are the reference's plain
engine's tokens on the same weights (``smoke_config("granite_3_2b")``, the
reference's ``init_params`` tree through ``convert.params_from_numpy``).
The speculative engines' counters (drafted, accepted, verify steps, prefix
hits) must equal the reference's too, and serving must add no plan-cache
key beyond ``warm()``. The cases mirror ``tests/test_serve_spec.py``.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.configs.registry import smoke_config as j_smoke
from repro.core import plan_cache as jcache
from repro.models import model as JM
from repro.train.steps import make_serve_prefill_step as j_serve_prefill
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import plan_cache as tcache
from repro_torch.serve import DraftModel, SelfDraft, ServeEngine
from repro_torch.train.steps import make_serve_prefill_step as t_serve_prefill

JCFG, TCFG = j_smoke("granite_3_2b"), t_smoke("granite_3_2b")
# one ragged request set shared by every exactness test in this file; the
# lengths cross both seq buckets (8, 16) and chunk boundaries
PROMPT_LENS = (5, 11, 3, 16, 7, 9)
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(max_slots=4, max_prompt_len=16, max_new_tokens=6, seed=0)
SPEC = dict(speculate=2, prefix_cache=True, prefill_chunk=8)
# ServeStats counters a speculative engine run must share with the reference's
SPEC_COUNTS = ("prefill_steps", "decode_steps", "verify_steps", "prompt_tokens",
               "generated_tokens", "decode_real_rows", "decode_emitted_tokens",
               "prefill_padded_tokens", "decode_padded_tokens", "drafted_tokens",
               "accepted_tokens", "prefix_hits", "prefix_misses", "prefix_tokens_reused",
               "bucket_hits", "bucket_misses", "requests_admitted", "requests_finished")


def _prompts(lens=PROMPT_LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, TCFG.vocab_size, int(n))) for n in lens]


@pytest.fixture(scope="module")
def weights():
    """The reference's weights as numpy, and the port's copy of them."""
    np_params = jax.tree.map(np.asarray, JM.init_params(JCFG, jax.random.PRNGKey(0)))
    return np_params, params_from_numpy(np_params, TCFG, device="cpu")


def _jengine(weights, **kw):
    jcache.reset()
    eng = jserve.ServeEngine(JCFG, jax.tree.map(jax.numpy.asarray, weights[0]), **{**KW, **kw})
    eng.warm()
    return eng


def _tengine(weights, **kw):
    tcache.reset()
    eng = ServeEngine(TCFG, weights[1], device="cpu", **{**KW, **kw})
    eng.warm()
    return eng


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    engine.run()
    return reqs


@pytest.fixture(scope="module")
def baseline(weights):
    """The plain engines of both packages on the same prompts, recording logits."""
    prompts = _prompts()
    jreqs = _serve(_jengine(weights, record_logits=True), prompts)
    treqs = _serve(_tengine(weights, record_logits=True), prompts)
    return prompts, jreqs, treqs


@pytest.fixture(scope="module")
def spec_served(weights):
    """Every feature on, serving the baseline's prompts twice (the second
    pass hits the prefix cache), in both packages."""
    prompts = _prompts()
    out = {}
    for name, make in (("ref", _jengine), ("port", _tengine)):
        eng = make(weights, **SPEC)
        out[name] = (eng, _serve(eng, prompts), _serve(eng, prompts))
    return out


def test_serve_prefill_step_matches_reference(weights):
    """The bucketed prefill step (right-padded prompts, a last index per
    row) of both packages on the same weights: each row's last-token logits
    and the whole cache they return, pad positions included."""
    lens = np.array([5, 16, 9])
    tokens = np.random.default_rng(5).integers(1, TCFG.vocab_size, (3, 16))
    tokens[np.arange(16)[None] >= lens[:, None]] = 0
    jl, jc = j_serve_prefill(JCFG, 32)(jax.tree.map(jax.numpy.asarray, weights[0]),
                                       jax.numpy.asarray(tokens, jax.numpy.int32),
                                       jax.numpy.asarray(lens - 1, jax.numpy.int32))
    tl, tc = t_serve_prefill(TCFG, 32)(weights[1], torch.as_tensor(tokens),
                                       torch.as_tensor(lens - 1))
    assert tl.shape == jl.shape == (3, 1, TCFG.vocab_size)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **TOL)
    assert tc.keys() == jc.keys()
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(), np.asarray(jc[name], np.float32),
                                   **TOL)


def test_plain_engine_matches_reference(baseline):
    _, jreqs, treqs = baseline
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
        for got, want in zip(t.logits, j.logits):
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pass_", ["first", "second"])
def test_speculative_identity_draft_token_exact(pass_, baseline, spec_served):
    """Identity-draft speculation, with chunked prefill, emits the plain
    engine's tokens; the second pass also reuses every prompt's prefix."""
    _, _, base = baseline
    eng, first, second = spec_served["port"]
    for b, r in zip(base, first if pass_ == "first" else second):
        assert r.generated == b.generated, (r.rid, r.generated, b.generated)
    assert eng.stats.acceptance_rate > 0
    assert eng.stats.verify_steps > 0 and eng.stats.decode_steps == 0
    assert isinstance(eng.draft, SelfDraft) and isinstance(eng.draft, DraftModel)


def test_spec_counters_match_reference(spec_served):
    """Drafts, acceptances, verify rounds and prefix hits: the reference's
    numbers, so the port's drafts are the reference's drafts."""
    jeng, _, _ = spec_served["ref"]
    teng, _, _ = spec_served["port"]
    js, ts = jeng.stats.as_dict(), teng.stats.as_dict()
    assert {k: ts[k] for k in SPEC_COUNTS} == {k: js[k] for k in SPEC_COUNTS}
    assert teng.prefix.stats() == jeng.prefix.stats()


def test_spec_stats_attribution(spec_served):
    """Verify rows are launched work, accepted tokens throughput, and each
    request's first token comes from prefill (the reference's invariants)."""
    eng, first, second = spec_served["port"]
    s = eng.stats
    n_req = len(first) + len(second)
    assert s.requests_finished == n_req
    assert 0 < s.acceptance_rate <= 1.0 and s.accepted_tokens <= s.drafted_tokens
    assert s.decode_real_rows == (s.drafted_tokens // 2) * 3
    assert s.generated_tokens == s.decode_emitted_tokens + n_req
    assert s.decode_padded_tokens >= s.decode_real_rows and s.padding_waste < 1.0


def test_prefix_reuse_hits(baseline, spec_served):
    prompts, _, _ = baseline
    eng, _, _ = spec_served["port"]
    assert eng.stats.prefix_hits == len(prompts) == eng.prefix.stats()["hits"]
    assert eng.stats.prefix_tokens_reused == sum(len(p) - 1 for p in prompts)


def test_speculative_shrunk_draft_token_exact(weights, baseline):
    """A 1-layer sliced draft mispredicts freely on random weights; greedy
    verify/rollback must still emit exactly the plain tokens, with the
    reference's acceptance counts."""
    prompts = _prompts((6, 13, 4), seed=11)
    kw = dict(speculate=2, draft_keep_layers=1, max_slots=2)
    plain = _serve(_tengine(weights, max_slots=2), prompts)
    teng = _tengine(weights, **kw)
    treqs = _serve(teng, prompts)
    jeng = _jengine(weights, **kw)
    jreqs = _serve(jeng, prompts)
    assert [r.generated for r in treqs] == [r.generated for r in plain] \
        == [r.generated for r in jreqs]
    assert teng.draft.keep_layers == 1 < TCFG.num_layers
    assert 0 < teng.stats.accepted_tokens < teng.stats.drafted_tokens
    assert (teng.stats.accepted_tokens, teng.stats.drafted_tokens) == \
        (jeng.stats.accepted_tokens, jeng.stats.drafted_tokens)


def test_chunked_prefill_logits_allclose_one_shot(weights, baseline):
    """Chunked prefill is numerically the same computation: the recorded
    per-step logits of a chunked engine match the plain engine's."""
    prompts, _, base = baseline
    reqs = _serve(_tengine(weights, prefill_chunk=8, record_logits=True), prompts)
    for b, r in zip(base, reqs):
        assert r.generated == b.generated
        for got, want in zip(r.logits, b.logits):
            np.testing.assert_allclose(got, want, **TOL)


def test_streaming_matches_final_output(spec_served):
    """Tokens seen through the iterator and the callback equal the request's
    final ``generated`` list, in order, under speculation."""
    eng, _, _ = spec_served["port"]
    rng = np.random.default_rng(9)
    cb = []
    r = eng.submit(list(rng.integers(1, TCFG.vocab_size, 7)), max_new_tokens=6,
                   stream=True, on_token=lambda rq, t: cb.append((rq.rid, t)))
    streamed = []
    th = threading.Thread(target=lambda: streamed.extend(r.token_stream(timeout=60)))
    th.start()
    eng.run()
    th.join(60)
    assert not th.is_alive()
    assert streamed == list(r.generated) and len(streamed) >= 1
    assert cb == [(r.rid, t) for t in r.generated]
    with pytest.raises(ValueError):
        next(spec_served["port"][1][0].token_stream())


def test_spec_serve_adds_no_plan_keys_beyond_warm(weights):
    """32 ragged speculative requests (γ=2, prefix cache, chunked prefill)
    touch only plan-cache keys ``warm()`` created."""
    eng = ServeEngine(TCFG, weights[1], device="cpu", max_slots=4, max_prompt_len=16,
                      max_new_tokens=4, **SPEC)
    tcache.reset()
    eng.warm()
    keys_warm = set(tcache.default_cache().keys())
    misses_warm = tcache.stats().misses
    rng = np.random.default_rng(0)
    for plen in rng.integers(2, 16, size=32):
        eng.submit(list(rng.integers(0, TCFG.vocab_size, int(plen))), max_new_tokens=4)
    assert len(eng.run()) == 32
    assert set(tcache.default_cache().keys()) == keys_warm and keys_warm
    assert tcache.stats().misses == misses_warm
    assert eng.stats.bucket_misses == 0 and eng.stats.acceptance_rate > 0
