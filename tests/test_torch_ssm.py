"""The port's SSM and hybrid families against the reference, on the CPU.

Same numpy inputs, made from a seed, through both packages: the reference
runs its generated ``"jnp"`` backend, the port its kernels' plain versions
(every wrapper takes its plain version on a CPU tensor), f32.

* The SSD mixer (``models/ssd.py``): ``ssd_scan`` and ``ssd_decode_step``
  in gemm mode and forced strassen, with a ragged tail and an
  ``init_state``, at the reference test's atol 2e-3, rtol 1e-3
  (``tests/test_config_matrix.py``); the chunked scan against the
  step-by-step recurrence at 2e-4 (``tests/test_models.py``); the plain
  versions (``models/ssd_ref.py``); ``ssd_apply`` with a ``length_mask``
  ends in the unpadded state; a fully padded row stays finite.
* The models: ``smoke_config("mamba2_370m")`` and ``("hymba_1_5b")``,
  prefill and four decode steps against the reference's at rtol/atol 2e-3
  (``tests/test_models.py``), equal greedy tokens, the same leaves
  precombined; a decode step equals the full forward's last position.
* Configs, the parameter tree, its conversion (the reference's float32
  leaves stay float32 in a bf16 tree), the registry's contractions.
* The engine: mamba2's token-exact against the reference's engine and
  against the port's own eager decode of each request; ``warm()`` covers
  every plan key a 32-request run touches (grouped SSD keys among them); a
  state snapshot is keyed at the whole prompt and a prompt that extends
  it hits it; chunked prefill equals unchunked; the chunk step zeroes a
  reused slot's state; speculation is refused; the launcher serves mamba2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
import repro.serve as jserve
from repro.configs import registry as jreg
from repro.core import engine as jengine, hardware as jhw, plan_cache as jcache
from repro.core import workloads as jwl
from repro.core.falcon_gemm import FalconConfig as JConfig
from repro.models import model as JM, ssd as JSSD
from repro.train.steps import make_decode_step as j_decode_step
from repro.train.steps import make_prefill_step as j_prefill_step
import repro_torch.api as tfalcon
import repro_torch.serve as tserve
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as tengine, hardware as thw, plan_cache as tcache
from repro_torch.core import workloads as twl
from repro_torch.core.falcon_gemm import FalconConfig as TConfig
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM, ssd as TSSD
from repro_torch.models.ssd_ref import einsum_ssd_scan, plain_ssd_apply, sequential_ssd
from repro_torch.train.steps import make_chunk_prefill_step

SSM_ARCHS = ["mamba2_370m", "hymba_1_5b"]
MODES = ("gemm", "strassen")
SCAN_TOL = dict(atol=2e-3, rtol=1e-3)      # tests/test_config_matrix.py
SEQ_TOL = dict(atol=2e-4, rtol=2e-4)       # tests/test_models.py
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)     # tests/test_models.py
ENGINE_TOL = dict(atol=1e-4, rtol=1e-4)    # tests/test_torch_serve_engine.py


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ssd_inputs(seed: int, B=2, L=24, H=4, P=16, G=2, N=16):
    """The reference test's ``_ssd_inputs`` draws, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, L, H))) * 0.1).astype(np.float32)
    A = (np.abs(rng.standard_normal((H,))) * 0.5).astype(np.float32)
    B_ = rng.standard_normal((B, L, G, N)).astype(np.float32)
    C_ = rng.standard_normal((B, L, G, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, A, B_, C_, s0


# ---------------------------------------------------------------------------
# The SSD mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("L", [24, 21], ids=["whole_chunks", "ragged_tail"])
def test_ssd_scan_matches_reference(mode, L):
    """The four planned contractions of the scan (forced strassen runs the
    LCMA pipeline on each), with an init_state, against the reference's
    ``ssd_scan`` on the same inputs; L = 21 pads the last chunk."""
    x, dt, A, B_, C_, s0 = _ssd_inputs(0, L=L)
    with jfalcon.use(JConfig(mode=mode, backend="jnp")):
        jy, js = JSSD.ssd_scan(*map(jnp.asarray, (x, dt, A, B_, C_)), chunk=8,
                               init_state=jnp.asarray(s0))
    with tfalcon.use(TConfig(mode=mode)):
        ty, ts = TSSD.ssd_scan(*map(_t, (x, dt, A, B_, C_)), chunk=8, init_state=_t(s0))
    assert ty.shape == (2, L, 4, 16) and ts.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCAN_TOL)
    # the plain einsum scan of models/ssd_ref.py, on the same inputs
    py, ps = einsum_ssd_scan(*map(_t, (x, dt, A, B_, C_)), chunk=8, init_state=_t(s0))
    np.testing.assert_allclose(ty.numpy(), py.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), ps.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_ssd_decode_step_matches_reference(mode):
    """The state update (K = 1, which strassen pads to 2) and the readout,
    both planned grouped contractions over B*H."""
    x, dt, A, B_, C_, s0 = _ssd_inputs(1)
    args = (x[:, :1], dt[:, :1], A, B_[:, :1], C_[:, :1], s0)
    with jfalcon.use(JConfig(mode=mode, backend="jnp")):
        jy, js = JSSD.ssd_decode_step(*map(jnp.asarray, args))
    with tfalcon.use(TConfig(mode=mode)):
        ty, ts = TSSD.ssd_decode_step(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCAN_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_scan_matches_the_sequential_recurrence(mode):
    """``tests/test_models.py::test_ssd_scan_matches_sequential``'s inputs:
    the chunked scan against the step-by-step recurrence (the plain one of
    ``models/ssd_ref.py``, and the port's decode step run position by
    position), at 2e-4."""
    rng = np.random.default_rng(2)
    B, L, H, P, G, N, chunk = 2, 16, 4, 8, 2, 16, 4
    x = _t(rng.standard_normal((B, L, H, P)))
    dt = _t(rng.uniform(0.1, 0.9, (B, L, H)))
    A = _t(rng.uniform(-1.5, -0.2, (H,)))
    B_ = _t(rng.standard_normal((B, L, G, N)) * 0.3)
    C_ = _t(rng.standard_normal((B, L, G, N)) * 0.3)
    with tfalcon.use(TConfig(mode=mode)):
        y, s = TSSD.ssd_scan(x, dt, A, B_, C_, chunk)
        st, ys = torch.zeros(B, H, N, P), []
        for t in range(L):
            y_t, st = TSSD.ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], A,
                                           B_[:, t:t + 1], C_[:, t:t + 1], st)
            ys.append(y_t)
    y_seq, s_seq = sequential_ssd(x, dt, A, B_, C_)
    for got_y, got_s in ((y, s), (torch.cat(ys, 1), st)):
        np.testing.assert_allclose(got_y.numpy(), y_seq.numpy(), **SEQ_TOL)
        np.testing.assert_allclose(got_s.numpy(), s_seq.numpy(), **SEQ_TOL)


def test_fully_padded_rows_stay_finite():
    """dt = 0 everywhere (every position masked): no -inf - -inf in the
    segment sums, the state is the init state decayed by exp(0) = 1."""
    x, _, A, B_, C_, s0 = _ssd_inputs(3)
    y, s = TSSD.ssd_scan(_t(x), torch.zeros(2, 24, 4), _t(A), _t(B_), _t(C_), 8,
                         init_state=_t(s0))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(s.numpy(), s0, atol=1e-6)


def _mixer(arch: str):
    """The reference's SSD mixer weights of ``arch``'s smoke config (dt_bias
    and A drawn, so the decays differ per head), as numpy."""
    cfg = jreg.smoke_config(arch)
    p = jax.tree.map(np.asarray, JSSD.ssd_init(jax.random.PRNGKey(4), cfg.d_model,
                                                cfg.ssm_state, cfg.ssm_heads,
                                                cfg.ssm_head_dim, cfg.ssm_groups,
                                                jnp.float32))
    rng = np.random.default_rng(4)
    p["ssm_A"] = rng.uniform(-1.0, 0.5, p["ssm_A"].shape).astype(np.float32)
    p["ssm_dt_bias"] = rng.uniform(-2.0, 0.0, p["ssm_A"].shape).astype(np.float32)
    return cfg, p


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_apply_with_length_mask_matches_reference(arch, mode):
    """Right-padded rows with a length mask: the mixer's output and final
    state against the reference's on the same mask."""
    cfg, p = _mixer(arch)
    x = np.random.default_rng(5).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    mask = (np.arange(20)[None] < np.array([[13], [20]])).astype(np.float32)
    with jfalcon.use(JConfig(mode=mode, backend="jnp")):
        jy, js = JSSD.ssd_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
                                length_mask=jnp.asarray(mask))
    tcfg = treg.smoke_config(arch)
    tp = {k: _t(v) for k, v in p.items()}
    with tfalcon.use(TConfig(mode=mode)):
        ty, ts = TSSD.ssd_apply(tp, _t(x), tcfg, length_mask=_t(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCAN_TOL)
    # the float32 plain version of the whole mixer
    py, ps = plain_ssd_apply(tp, _t(x), tcfg, length_mask=_t(mask))
    np.testing.assert_allclose(ty.numpy(), py.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), ps.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_length_mask_gives_the_unpadded_state(arch):
    """dt = 0 on masked positions: a row padded past its length with
    arbitrary tokens ends in the state of the row cut to its length, to
    float32 rounding in gemm mode (the projections run at another M), and
    within the scan tolerance through strassen's combines (which mix the
    padded rows in and cancel them)."""
    cfg, p = _mixer(arch)
    tcfg = treg.smoke_config(arch)
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(np.random.default_rng(6).standard_normal((1, 21, cfg.d_model)))
    mask = (torch.arange(21) < 13).float()[None]
    for mode in MODES:
        with tfalcon.use(TConfig(mode=mode)):
            _, padded = TSSD.ssd_apply(tp, x, tcfg, length_mask=mask)
            _, cut = TSSD.ssd_apply(tp, x[:, :13], tcfg)
        tol = dict(atol=1e-6, rtol=1e-6) if mode == "gemm" else SCAN_TOL
        np.testing.assert_allclose(padded.numpy(), cut.numpy(), **tol)


# ---------------------------------------------------------------------------
# Configs, parameters, contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_config_matches_reference(arch):
    """Every field of the port's ModelConfig (the SSM ones among them) in
    the full config and both smoke configs; the backend default is the
    port's own ("cuda")."""
    fields = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "falcon_backend"]
    for get in ("get_config", "smoke_config", "lcma_smoke_config"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}, get
        assert t.layer_windows() == j.layer_windows()
        assert t.is_attention_free == j.is_attention_free == (arch == "mamba2_370m")
        assert t.ssm_heads % t.ssm_groups == 0
    smoke = treg.smoke_config(arch)
    assert smoke.ssm_chunk < 16        # a 16-token smoke prompt spans chunks
    assert TM.padded_vocab(treg.get_config(arch)) == JM.padded_vocab(jreg.get_config(arch))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_tree_and_conversion_match_reference(arch):
    """The port's ``init_params`` has the reference's leaves and shapes
    (mamba2: ``layers/{ln1, ssm/..}`` only; hymba: attention, ``ssm``,
    ``attn_norm``, ``ssm_norm`` and the MLP), the SSD leaves ``ssm_A``,
    ``ssm_D``, ``ssm_dt_bias`` in float32 in a bf16 model, and
    ``params_from_numpy`` carries the reference's weights across exactly."""
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = _flat(TM.init_params(cfg, 0, device="cpu"))
    conv = _flat(params_from_numpy(jparams, cfg, device="cpu"))
    ref = _flat(jparams)
    assert sorted(mine) == sorted(conv) == sorted(ref)
    assert ("layers/attn/w_q" in ref) == (arch == "hymba_1_5b")
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape == tuple(conv[k].shape), k
        np.testing.assert_array_equal(conv[k].numpy(), v)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    for k, v in _flat(TM.init_params(bf, 0, device="cpu")).items():
        leaf = k.rsplit("/", 1)[-1]
        assert v.dtype == (torch.float32 if leaf in TSSD.F32_LEAVES else torch.bfloat16), k


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_conversion_keeps_the_reference_float32_leaves(arch):
    """A bf16 reference tree (its ``ssm_A``/``ssm_D``/``ssm_dt_bias`` float32,
    the rest bf16) converts to the same dtypes, values unchanged."""
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(treg.smoke_config(arch), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    ref, conv = _flat(jparams), _flat(params_from_numpy(jparams, cfg, device="cpu"))
    f32 = [k for k, v in ref.items() if v.dtype == np.float32]
    assert sorted(k.rsplit("/", 1)[-1] for k in f32) == sorted(TSSD.F32_LEAVES)
    for k, v in ref.items():
        want = torch.float32 if k in f32 else torch.bfloat16
        assert conv[k].dtype == want, k
        np.testing.assert_array_equal(conv[k].float().numpy(), v.astype(np.float32))


def _fields(c):
    return (c.kind, c.role, c.m, c.k, c.n, c.group, c.shared_b, c.weight_static)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_contractions_match_reference(arch):
    """``contraction_set`` and ``resolve_contractions`` at a prefill, a
    2048-token prefill (8 chunks of 256), a cached chunk, decode and every
    engine bucket, key for key the reference's: the SSD scan's four grouped
    contractions (or, decoding, the recurrence's two) and hybrid's
    attention beside them."""
    spec = ("kind", "role", "m", "k", "n", "group", "shared_b", "weight_static")
    for cfg in (arch, treg.smoke_config(arch)):
        jc = arch if isinstance(cfg, str) else jreg.smoke_config(arch)
        assert [tuple(getattr(s, f) for f in spec) for s in twl.contraction_set(cfg)] == \
            [tuple(getattr(s, f) for f in spec) for s in jwl.contraction_set(jc)]
        for batch, seq, kw in ((4, 2048, {}), (2, 21, {}), (8, 16, dict(kv_len=64)),
                               (4, 1, dict(decode=True, kv_len=2064)),
                               (8, 1, dict(decode=True, kv_len=128))):
            got = [_fields(c) for c in twl.resolve_contractions(cfg, batch, seq, **kw)]
            want = [_fields(c) for c in jwl.resolve_contractions(jc, batch, seq, **kw)]
            assert got == want, (batch, seq, kw)
            kinds = {c[0] for c in got}
            assert ("ssd_decode" in kinds) == bool(kw.get("decode"))
            assert ("ssd_scan" in kinds) != bool(kw.get("decode"))
            assert ("attention" in kinds) == (arch == "hymba_1_5b")
    assert twl.dense_projection_shapes(arch) == jwl.dense_projection_shapes(arch)
    assert twl.warm_shapes(arch) == jwl.warm_shapes(arch)
    assert all(s.layers == () for s in twl.contraction_set(arch))


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

B, S, GEN = 2, 20, 5            # a prefill over three 8-token chunks + 4 decode steps


def _reference_run(arch: str, mode: str):
    """The reference's one-shot prefill + decode (jit, "jnp" backend) on its
    own seed-0 weights: (params as numpy, last-position logits per step,
    greedy tokens, n_precombined)."""
    cfg = dataclasses.replace(jreg.smoke_config(arch), falcon_mode=mode,
                              falcon_backend="jnp")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    logits, tokens = [], []
    with jfalcon.use(JM.falcon_config_for(cfg)):
        planned, n_pre = jfalcon.precombine_params(params, m_hint=B * S)
        prefill = jax.jit(j_prefill_step(cfg, max_len=S + GEN))
        decode = jax.jit(j_decode_step(cfg))
        lg, cache = prefill(planned, jnp.asarray(prompts, jnp.int32))
        for i in range(GEN):
            logits.append(np.asarray(lg[:, -1]))
            nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
            tokens.append(np.asarray(nxt))
            if i + 1 < GEN:
                lg, cache = decode(planned, cache, nxt[:, None], S + i)
    return jax.tree.map(np.asarray, params), logits, np.stack(tokens, 1), n_pre


@pytest.fixture(scope="module", params=[(a, m) for a in SSM_ARCHS for m in MODES],
                ids=lambda c: "-".join(c))
def model_pair(request):
    arch, mode = request.param
    np_params, logits, tokens, n_pre = _reference_run(arch, mode)
    cfg = dataclasses.replace(treg.smoke_config(arch), falcon_mode=mode)
    res = tlaunch.run_oneshot(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device="cpu",
                              params=params_from_numpy(np_params, cfg, device="cpu"))
    return (arch, mode), (logits, tokens, n_pre), res


def test_model_logits_match_reference(model_pair):
    case, (logits, _, _), res = model_pair
    assert len(res["logits"]) == len(logits) == GEN
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{case} step {step}",
                                   **MODEL_TOL)


def test_model_tokens_and_precombine_match_reference(model_pair):
    (arch, mode), (_, tokens, n_pre), res = model_pair
    np.testing.assert_array_equal(res["tokens"].numpy(), tokens)
    leaves = {"mamba2_370m": 2, "hymba_1_5b": 9}[arch]    # ssm_in/out (+ attention, MLP)
    assert res["n_precombined"] == n_pre == {"gemm": 0, "strassen": leaves}[mode]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill of S-1 tokens into a cache, then one decode step (the SSD
    recurrence), equals the last position of the full forward
    (``tests/test_models.py::test_decode_matches_full_forward``)."""
    cfg = treg.smoke_config(arch)
    params = TM.init_params(cfg, 1, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 12)))
    with torch.inference_mode():
        full, _ = TM.forward(params, cfg, tokens, logits_mode="all")
        cache = TM.init_cache(cfg, 1, 16, device="cpu")
        TM.forward(params, cfg, tokens[:, :11], cache=cache, cache_index=0)
        dec, _ = TM.forward(params, cfg, tokens[:, 11:], cache=cache, cache_index=11,
                            logits_mode="last")
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), **MODEL_TOL)
    assert set(cache) == ({"state"} if arch == "mamba2_370m" else {"k", "v", "state"})
    assert cache["state"].shape == (cfg.num_layers, 1, cfg.ssm_heads, cfg.ssm_state,
                                    cfg.ssm_head_dim)


def test_chunk_step_zeroes_a_reused_slot_state():
    """A first-chunk row (start 0) starts from zero state whatever the slot
    held; a resumed row (start > 0) keeps it."""
    cfg = treg.smoke_config("mamba2_370m")
    params = TM.init_params(cfg, 2, device="cpu")
    step = make_chunk_prefill_step(cfg)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 8)))
    last = torch.tensor([7, 7])

    def run(state_fill, start):
        cache = TM.init_cache(cfg, 2, 16, device="cpu")
        cache["state"].fill_(state_fill)
        logits, cache = step(params, cache, tokens, torch.tensor(start), last)
        return logits, cache["state"]

    clean, clean_state = run(0.0, [0, 0])
    stale, stale_state = run(3.0, [0, 0])
    assert torch.equal(clean, stale) and torch.equal(clean_state, stale_state)
    resumed, _ = run(3.0, [0, 8])
    assert torch.equal(resumed[0], clean[0]) and not torch.equal(resumed[1], clean[1])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, max_prompt_len=16, max_new_tokens=4, record_logits=True)
PROMPT_LENS = (3, 8, 11, 16, 5, 13)


def _requests(vocab: int):
    rng = np.random.default_rng(7)
    return [(list(rng.integers(0, vocab, n)), int(rng.integers(1, 5))) for n in PROMPT_LENS]


def _serve(engine, reqs):
    engine.warm()
    out = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    engine.run()
    return out


@pytest.fixture(scope="module")
def mamba_engines():
    """Both engines serving 6 ragged requests (3 to 16 tokens: one to two
    8-token chunks) on mamba2's smoke config, forced strassen, same weights."""
    jcfg = dataclasses.replace(jreg.smoke_config("mamba2_370m"), falcon_mode="strassen",
                               falcon_backend="jnp")
    tcfg = dataclasses.replace(treg.smoke_config("mamba2_370m"), falcon_mode="strassen")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    reqs = _requests(jcfg.vocab_size)
    jcache.reset()
    jout = _serve(jserve.ServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                                     **ENGINE_KW), reqs)
    tcache.reset()
    teng = tserve.ServeEngine(tcfg, params_from_numpy(np_params, tcfg, device="cpu"),
                              device="cpu", **ENGINE_KW)
    tout = _serve(teng, reqs)
    return teng, jout, tout


def test_mamba2_engine_matches_reference_engine(mamba_engines):
    teng, jout, tout = mamba_engines
    for j, t in zip(jout, tout):
        assert t.done and t.generated == list(j.generated), (t.rid, t.generated, j.generated)
        for step, (got, want) in enumerate(zip(t.logits, j.logits)):
            np.testing.assert_allclose(got, np.asarray(want),
                                       err_msg=f"request {t.rid} step {step}", **ENGINE_TOL)
    s = teng.summary()
    assert s["precombined_weights"] == 2 and s["bucket_misses"] == 0


def test_mamba2_engine_matches_eager_decode(mamba_engines):
    """Right-padded bucketed prefill (dt zeroed on pad) and per-slot decode
    equal each request decoded alone through the model, token for token
    (reference ``test_mamba2_engine_output_allclose_vs_eager_decode``)."""
    teng, _, tout = mamba_engines
    cfg = teng.cfg
    with tfalcon.use(teng.fcfg), torch.inference_mode():
        for req in tout:
            cache = TM.init_cache(cfg, 1, teng.max_len, device="cpu")
            logits, _ = TM.forward(teng.params, cfg, torch.as_tensor([req.prompt]),
                                   cache=cache, cache_index=0, logits_mode="last")
            gen = [int(logits[0, -1].argmax())]
            for pos in range(len(req.prompt), len(req.prompt) + req.max_new_tokens - 1):
                logits, _ = TM.forward(teng.params, cfg, torch.tensor([[gen[-1]]]),
                                       cache=cache, cache_index=pos, logits_mode="last")
                gen.append(int(logits[0, -1].argmax()))
            assert gen == req.generated, (len(req.prompt), gen, req.generated)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_warm_covers_every_serve_plan_key(arch):
    """32 ragged requests touch only plan-cache keys ``warm()`` made, the
    grouped SSD scan and decode keys among them (reference
    ``tests/test_serve_engine.py::test_warm_covers_all_serve_plan_keys``)."""
    cfg = treg.smoke_config(arch)
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
        groups = {c.group for c in twl.resolve_contractions(cfg, 4, 16)
                  if c.kind == "ssd_scan"}
        assert any(f"|g{g}x" in k for k in keys_warm for g in groups)
    finally:
        tcache.reset()


@pytest.fixture
def parity_profile():
    """An LCMA-friendly profile in both packages (as in
    ``tests/test_torch_serve_engine.py``), their plan caches emptied."""
    prof = dict(name="ssm_parity_profile", flops_mul=2e12, flops_add=5e13, beta=4e13,
                hbm_bytes=1 << 30, vmem_bytes=1 << 20, mxu_align=8, dtype_flops=None,
                lcma_gemm_efficiency=1.0)
    jhw.register_profile(jhw.HardwareProfile(**prof))
    thw.register_profile(thw.HardwareProfile(**prof))
    jcache.reset()
    tcache.reset()
    yield prof["name"]
    jcache.reset()
    tcache.reset()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_warm_buckets_makes_the_reference_plans(arch, parity_profile):
    """The SSD scan and decode contractions at each bucket, key for key the
    reference's (f32 smoke configs, where the scan's float32 is the model's
    dtype)."""
    buckets = [(b, s) for b in (1, 2) for s in (8, 16)] + [(1, 1), (2, 1)]
    cand = ("strassen", "strassen-winograd", "s223")
    jn = jengine.warm_buckets(JConfig(hardware=parity_profile, candidates=cand),
                              jreg.smoke_config(arch), buckets, dtype="float32", kv_len=32)
    tn = tengine.warm_buckets(TConfig(hardware=parity_profile, candidates=cand),
                              treg.smoke_config(arch), buckets, dtype="float32", kv_len=32)
    assert tn == jn > 0
    keys = lambda c: sorted("|".join(p for p in k.split("|")[1:]  # noqa: E731
                                     if not p.startswith("fused="))
                            for k in c.default_cache().keys())
    assert keys(tcache) == keys(jcache)


def test_warm_plans_the_ssd_contractions_in_float32():
    """In a bf16 model the SSD contractions still run in float32, so warm
    plans them under float32 keys (the projections under bf16)."""
    cfg = dataclasses.replace(treg.smoke_config("mamba2_370m"), dtype="bfloat16")
    tcache.reset()
    try:
        tengine.warm_buckets(TConfig(), cfg, [(2, 16), (2, 1)], kv_len=32)
        dtypes = {}
        for k in tcache.default_cache().keys():
            grouped = twl.shape_token(k).startswith("g")
            dtypes.setdefault(grouped, set()).add(k.split("|")[1])
        assert dtypes == {True: {"float32"}, False: {"bfloat16"}}
    finally:
        tcache.reset()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_state_snapshot_is_keyed_at_the_whole_prompt(arch):
    """A state-bearing cache snapshots the whole prompt (a state is valid
    only at its exact length); a prompt extending it resumes from it and
    gives the tokens of a cache-less engine (reference
    ``tests/test_serve_spec.py::test_ssm_prefix_continuation_token_exact``)."""
    cfg = treg.smoke_config(arch)
    rng = np.random.default_rng(5)
    head = list(rng.integers(1, cfg.vocab_size, 9))
    cont = head + list(rng.integers(1, cfg.vocab_size, 3))
    kw = dict(max_slots=2, max_prompt_len=16, max_new_tokens=5, seed=0, device="cpu")
    base = tserve.ServeEngine(cfg, **kw)
    base.warm()
    rb = base.submit(cont, max_new_tokens=5)
    base.run()
    eng = tserve.ServeEngine(cfg, prefix_cache=True, **kw)
    eng.warm()
    eng.submit(head, max_new_tokens=5)
    eng.run()
    n, entry = eng.prefix.lookup(head)
    assert n == len(head) and entry.payload["state"].shape == (
        cfg.num_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    assert ("k" in entry.payload) == (arch == "hymba_1_5b")
    r = eng.submit(cont, max_new_tokens=5)
    eng.run()
    assert r.generated == rb.generated
    assert eng.stats.prefix_hits == 1 and eng.stats.prefix_tokens_reused == len(head)
    # resubmitted, the prompt cannot resume from its own whole-prompt
    # snapshot (a lookup leaves one token to prefill): it resumes from the
    # head's again, with the same tokens
    again = eng.submit(cont, max_new_tokens=5)
    eng.run()
    assert again.generated == rb.generated
    assert eng.stats.prefix_hits == 2 and eng.stats.prefix_tokens_reused == 2 * len(head)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_chunked_prefill_equals_unchunked(arch):
    """Prompts longer than the 8-token chunk prefill in pieces, the state
    carried through the slot cache: tokens equal, logits within 1e-4."""
    cfg = treg.smoke_config(arch)
    reqs = _requests(cfg.vocab_size)
    kw = dict(max_slots=2, max_prompt_len=16, max_new_tokens=4, record_logits=True,
              seed=0, device="cpu")
    plain = _serve(tserve.ServeEngine(cfg, **kw), reqs)
    chunked = _serve(tserve.ServeEngine(cfg, prefill_chunk=8, **kw), reqs)
    for a, b in zip(plain, chunked):
        assert a.generated == b.generated
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, x, **ENGINE_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_speculation_is_refused(arch):
    """Recurrent state cannot roll back past a rejected draft."""
    with pytest.raises(ValueError, match="specul"):
        tserve.ServeEngine(treg.smoke_config(arch), device="cpu", speculate=2)


def test_launcher_serves_mamba2_on_cpu(capsys):
    tlaunch.main(["--arch", "mamba2_370m", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "sample:" in out
    tlaunch.main(["--arch", "hymba_1_5b", "--device", "cpu", "--continuous", "--requests",
                  "4", "--prompt-len", "16", "--gen", "3", "--prefix-cache"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "0 CUDA graphs" in out


# ---------------------------------------------------------------------------
# bf16 rounding at published width
# ---------------------------------------------------------------------------

def test_bf16_rounding_matches_reference():
    """mamba2_370m at its published width, cut to 4 layers, gemm, one 1 x 256
    prompt: one numpy f32 weight set (the reference's seed-0 init), cast to
    each dtype the way each package's own init casts it. The port's bf16
    logits must sit no further from its f32 logits than 1.5x the reference's
    own bf16-vs-f32 gap, and no further from the reference's bf16 logits
    than that gap. The error is max |diff| / max |ref| over the real
    vocabulary (the padded columns hold -1e30). The SiLU must round as
    ``jax.nn.silu`` does (``models.layers.silu``) for this to hold."""
    depth, S = 4, 256
    jbase = dataclasses.replace(jreg.get_config("mamba2_370m"), num_layers=depth,
                                falcon_mode="gemm", falcon_backend="jnp")
    tbase = dataclasses.replace(treg.get_config("mamba2_370m"), num_layers=depth,
                                falcon_mode="gemm")
    np_params = jax.tree.map(np.asarray, JM.init_params(
        dataclasses.replace(jbase, dtype="float32"), jax.random.PRNGKey(0)))
    prompt = np.random.default_rng(0).integers(0, jbase.vocab_size, (1, S))
    V = jbase.vocab_size

    def ref(dtype):
        cfg = dataclasses.replace(jbase, dtype=dtype)

        def cast(path, a):      # the reference's init keeps the SSD f32 leaves
            f32 = any(n in jax.tree_util.keystr(path) for n in TSSD.F32_LEAVES)
            return jnp.asarray(a) if f32 else jnp.asarray(a).astype(dtype)
        params = jax.tree_util.tree_map_with_path(cast, np_params)
        with jfalcon.use(JM.falcon_config_for(cfg)):
            lg, _ = jax.jit(j_prefill_step(cfg, max_len=S))(params, jnp.asarray(prompt))
        return np.asarray(lg, np.float32)[0, -1, :V]

    def port(dtype):
        cfg = dataclasses.replace(tbase, dtype=dtype)
        params = params_from_numpy(np_params, cfg, device="cpu")
        lg, _ = TM.forward(params, cfg, torch.from_numpy(prompt), logits_mode="last")
        return lg.float().numpy()[0, -1, :V]

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    r32, r16, t32, t16 = ref("float32"), ref("bfloat16"), port("float32"), port("bfloat16")
    ref_gap = rel(r16, r32)
    assert rel(t32, r32) < 1e-4                     # the packages agree in f32
    assert rel(t16, t32) <= 1.5 * ref_gap, (rel(t16, t32), ref_gap)
    assert rel(t16, r16) <= ref_gap, (rel(t16, r16), ref_gap)
