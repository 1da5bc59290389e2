"""The port's MoE family against the reference, on the CPU.

Same numpy inputs, made from a seed, through both packages: the reference
runs its generated ``"jnp"`` backend (as ``tests/test_grouped.py`` runs
it), the port its kernels' plain versions (every wrapper takes its plain
version on a CPU tensor), f32.

* ``moe_apply`` at ``_tiny_moe``'s sizes and at ``smoke_config("dbrx_132b")``
  in gemm mode and in forced strassen: equal ``expert_idx``, ``y`` at
  rtol/atol 1e-4, the aux loss at rtol 1e-5; one case feeds both packages
  the same router logits, so a near-tie cannot flip a route.
* ``models.moe_ref.loop_moe_apply``, a dispatch of its own, against the
  grouped layer, with and without dropped pairs.
* Planned experts: a single layer's 3-D stacks lift to 4-D B̃ and match the
  eager path at 2e-4; ``plan_weight(grouped=True)`` accepts where the
  per-element decision declines, on an H100-like profile; a whole model's
  4-D stacks stay raw, exactly the leaves the reference lifts.
* Grouped plan keys: one ``|gE×`` key per projection shape.
* Workloads: ``moe_capacity``, ``grouped_moe_shapes`` and
  ``resolve_contractions`` for dbrx and kimi at prefill, decode and every
  engine bucket.
* The expert share: two halves of the experts add up to the whole layer.
* The models: dbrx and kimi smoke, prefill logits and four decode steps
  through the cache at rtol/atol 1e-4, equal greedy tokens.
* Configs, the parameter tree, its conversion and the per-expert draw.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.configs import registry as jreg
from repro.core import engine as jengine, hardware as jhw
from repro.core import workloads as jwl
from repro.core.falcon_gemm import FalconConfig as JConfig
from repro.models import model as JM, moe as jmoe
from repro.train.steps import make_decode_step, make_prefill_step
import repro_torch.api as tfalcon
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as tengine, hardware as thw, plan_cache as tcache
from repro_torch.core import workloads as twl
from repro_torch.core.falcon_gemm import FalconConfig as TConfig
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as TM, moe as tmoe
from repro_torch.models.moe_ref import eager_expert_ffn, eager_moe_apply, loop_moe_apply
from repro_torch.serve.buckets import BucketPolicy

MOE_ARCHS = ["dbrx_132b", "kimi_k2_1t"]
TOL = dict(rtol=1e-4, atol=1e-4)
EAGER_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_RTOL = 1e-5
MODES = ("gemm", "strassen")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _layer(size: str):
    """One MoE layer's weights (the reference's ``moe_init``, as numpy), the
    input x (numpy, default_rng), top-k and capacity factor: ``tiny`` is
    ``tests/test_grouped.py``'s ``_tiny_moe``; ``dbrx`` the smoke config's
    widths (d 64, d_ff 128, 4 experts, top-2)."""
    if size == "tiny":
        d, ff, E, k, cf, key, shape = 16, 32, 4, 2, 1.5, 3, (2, 8)
    else:
        c = jreg.smoke_config("dbrx_132b")
        d, ff, E, k, cf, key, shape = (c.d_model, c.d_ff, c.num_experts,
                                       c.experts_per_token, c.capacity_factor, 5, (2, 16))
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(key), d, ff, E,
                                                jnp.float32))
    x = np.random.default_rng(0).standard_normal((*shape, d)).astype(np.float32)
    return p, x, k, cf


def _jcfg(mode: str) -> JConfig:
    return JConfig(mode=mode, backend="jnp")


def _tcfg(mode: str) -> TConfig:
    return TConfig(mode=mode)


def _ref_idx(p, x, k):
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) @ jnp.asarray(p["router"])
    return np.asarray(jmoe._route(None, logits, k)[2])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", ["tiny", "dbrx"])
def test_moe_apply_matches_reference(size, mode):
    p, x, k, cf = _layer(size)
    with jfalcon.use(_jcfg(mode)):
        jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), top_k=k,
                                  capacity_factor=cf)
    with tfalcon.use(_tcfg(mode)):
        ty, taux = tmoe.moe_apply(_tree_t(p), _t(x), top_k=k, capacity_factor=cf)
    xt = _t(x).reshape(-1, x.shape[-1])
    t_idx = tmoe._route(xt, xt @ _t(p["router"]), k)[2]
    np.testing.assert_array_equal(t_idx.numpy(), _ref_idx(p, x, k))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_dispatch_on_shared_router_logits(mode):
    """Both packages route the same f32 logits (so no rounding of the router
    product can flip a near-tie), then dispatch, run the experts and
    combine: equal routes, equal capacity drops, ``y`` within 1e-4."""
    p, x, k, cf = _layer("dbrx")
    T, d = x.shape[0] * x.shape[1], x.shape[-1]
    E = p["router"].shape[1]
    logits = np.random.default_rng(1).standard_normal((T, E)).astype(np.float32)
    C = jwl.moe_capacity(T, k, E, 0.5)             # a tight capacity: drops tokens
    assert C == twl.moe_capacity(T, k, E, 0.5)
    xt = x.reshape(T, d)
    jr = jmoe._route(None, jnp.asarray(logits), k)
    tr = tmoe._route(None, _t(logits), k)
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    with jfalcon.use(_jcfg(mode)):
        jy = jmoe._dispatch_compute_combine(jnp.asarray(xt), *jr, C, p["moe_gate"],
                                            p["moe_up"], p["moe_down"], E_local=E, e_offset=0)
    with tfalcon.use(_tcfg(mode)):
        ty = tmoe._dispatch_compute_combine(_t(xt), *tr, C, _t(p["moe_gate"]),
                                            _t(p["moe_up"]), _t(p["moe_down"]),
                                            E_local=E, e_offset=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # the capacity really dropped some (token, choice) pairs
    assert (np.bincount(np.asarray(jr[2]).ravel(), minlength=E) > C).any()


def test_expert_share_adds_up_to_the_layer():
    """``_dispatch_compute_combine`` over experts [0, E/2) plus [E/2, E): the
    whole layer (the reference's expert-parallel ``psum``, on one device)."""
    p, x, k, cf = _layer("dbrx")
    tp, xt = _tree_t(p), _t(x).reshape(-1, x.shape[-1])
    T, E = xt.shape[0], tp["router"].shape[1]
    C = twl.moe_capacity(T, k, E, cf)
    probs, gates, idx = tmoe._route(xt, xt @ tp["router"], k)
    w = (tp["moe_gate"], tp["moe_up"], tp["moe_down"])
    with tfalcon.use(_tcfg("strassen")):
        whole = tmoe._dispatch_compute_combine(xt, probs, gates, idx, C, *w, E_local=E,
                                               e_offset=0)
        halves = sum(tmoe._dispatch_compute_combine(
            xt, probs, gates, idx, C, *(t[o:o + E // 2] for t in w), E_local=E // 2,
            e_offset=o) for o in (0, E // 2))
    torch.testing.assert_close(halves, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_moe_apply_matches_the_plain_version(mode):
    """The grouped path (gemm or the strassen pipeline's plain versions)
    against ``models.moe_ref``: the per-expert loop of plain matmuls."""
    p, x, k, cf = _layer("dbrx")
    tp, tx = _tree_t(p), _t(x)
    C = twl.moe_capacity(tx.shape[0] * tx.shape[1], k, tp["router"].shape[1], cf)
    with tfalcon.use(_tcfg(mode)):
        y, aux = tmoe.moe_apply(tp, tx, top_k=k, capacity_factor=cf)
    y_ref, aux_ref, _ = eager_moe_apply(tp, tx, k, C)
    torch.testing.assert_close(y, y_ref, **EAGER_TOL)
    torch.testing.assert_close(aux, aux_ref, rtol=AUX_RTOL, atol=0)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_loop_plain_version_matches_moe_apply(cf):
    """``models.moe_ref.loop_moe_apply`` (the layer with a dispatch of its
    own, which ``chip_smoke.py`` holds each full-width layer's gemm run to)
    against the grouped layer in gemm mode: equal routes, ``y`` at 1e-5,
    and the drops it counts equal to the pairs past each expert's
    capacity."""
    p, x, k, _ = _layer("dbrx")
    tp, tx = _tree_t(p), _t(x)
    E, T = tp["router"].shape[1], tx.shape[0] * tx.shape[1]
    C = twl.moe_capacity(T, k, E, cf)
    with tfalcon.use(_tcfg("gemm")):
        y, _ = tmoe.moe_apply(tp, tx, top_k=k, capacity_factor=cf)
    y_loop, idx, dropped = loop_moe_apply(tp, tx, k, C)
    np.testing.assert_array_equal(idx.numpy(), _ref_idx(p, x, k))
    torch.testing.assert_close(y_loop, y, rtol=1e-5, atol=1e-5)
    assert dropped == np.maximum(np.bincount(idx.numpy().ravel(), minlength=E) - C, 0).sum()
    assert dropped > 0 or cf > 1


def test_planned_experts_match_eager_and_reference():
    """A layer's 3-D expert stacks through ``precombine_params`` (forced
    strassen) lift to stacked PlannedWeights with a 4-D B̃; ``moe_apply``
    on them matches the eager path at 2e-4 (reference
    ``tests/test_grouped.py``) and the reference's planned run at 1e-4."""
    p, x, k, cf = _layer("tiny")
    with tfalcon.use(_tcfg("strassen")):
        planned, n = tfalcon.precombine_params(_tree_t(p), m_hint=64)
        assert n >= 3
        pw = planned["moe_gate"]
        assert isinstance(pw, tengine.PlannedWeight) and pw.bt.ndim == 4
        assert pw.bt.shape[0] == 4 and pw.algo == "strassen"
        y, aux = tmoe.moe_apply(planned, _t(x), top_k=k, capacity_factor=cf)
    with tfalcon.use(TConfig(enabled=False)):
        y_ref, aux_ref = tmoe.moe_apply(_tree_t(p), _t(x), top_k=k, capacity_factor=cf)
    torch.testing.assert_close(y, y_ref, **EAGER_TOL)
    torch.testing.assert_close(aux, aux_ref, rtol=AUX_RTOL, atol=0)
    with jfalcon.use(_jcfg("strassen")):
        jplanned, jn = jfalcon.precombine_params(jax.tree.map(jnp.asarray, p), m_hint=64)
        jy, _ = jmoe.moe_apply(jplanned, jnp.asarray(x), top_k=k, capacity_factor=cf)
    assert n == jn
    np.testing.assert_allclose(pw.bt.numpy(), np.asarray(jplanned["moe_gate"].bt), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.fixture
def moe_gate_profile():
    """An H100-like profile (the data sheet with the reference test's batching
    efficiency 0.35 and 8x the memory rate), registered in both packages."""
    fields = dataclasses.asdict(dataclasses.replace(
        thw.H100_SXM, name="moe_gate_test", lcma_gemm_efficiency=0.35,
        beta=thw.H100_SXM.beta * 8))
    thw.register_profile(thw.HardwareProfile(**fields))
    jhw.register_profile(jhw.HardwareProfile(**fields))
    yield fields["name"]


def test_plan_weight_grouped_accepts_where_per_element_declines(moe_gate_profile):
    """Stacked experts are lifted iff the *grouped* decision (plan_batched
    at m_hint // E rows per expert) accepts: here it does, where the
    per-element 2-D decision at the same rows declines (reference
    ``tests/test_grouped.py::test_precombine_params_gates_moe_stack_on_grouped_decision``),
    and both packages pick the same scheme."""
    E, C, d, ff = 16, 256, 512, 1792
    w3 = torch.zeros((E, d, ff), dtype=torch.bfloat16)
    with tfalcon.use(TConfig(hardware=moe_gate_profile)):
        pw = tengine.plan_weight(w3, m_hint=E * C, grouped=True)
        assert pw.precombined and pw.bt.ndim == 4
        assert not tengine.plan_weight(w3, m_hint=C).precombined
        lifted, n = tfalcon.precombine_params({"moe": {"moe_gate": w3}}, m_hint=E * C)
        assert n == 1 and lifted["moe"]["moe_gate"].algo == pw.algo
    with jfalcon.use(JConfig(hardware=moe_gate_profile)):
        jpw = jengine.plan_weight(jnp.zeros((E, d, ff), jnp.bfloat16), m_hint=E * C,
                                  grouped=True)
    assert jpw.algo == pw.algo


def _lifted(tree, path=""):
    if isinstance(tree, dict):
        return sorted(q for k, v in tree.items() for q in _lifted(v, f"{path}/{k}"))
    return [path] if hasattr(tree, "bt") and tree.bt is not None else []


def _jlifted(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jengine.PlannedWeight))[0]
    return sorted("/" + "/".join(str(getattr(k, "key", k)) for k in path)
                  for path, leaf in flat if isinstance(leaf, jengine.PlannedWeight))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_model_expert_stacks_stay_raw(arch):
    """``precombine_params`` over a whole MoE model in forced strassen lifts
    exactly the leaves the reference lifts: the four attention projections.
    The 4-D (layer, expert, K, N) stacks stay raw arrays, in both."""
    cfg = dataclasses.replace(treg.smoke_config(arch), falcon_mode="strassen")
    jcfg = dataclasses.replace(jreg.smoke_config(arch), falcon_mode="strassen",
                               falcon_backend="jnp")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    with jfalcon.use(JM.falcon_config_for(jcfg)):
        jp, jn = jfalcon.precombine_params(jax.tree.map(jnp.asarray, np_params), m_hint=64)
    with tfalcon.use(TM.falcon_config_for(cfg)):
        tp, tn = tfalcon.precombine_params(params_from_numpy(np_params, cfg, device="cpu"),
                                           m_hint=64)
    assert _lifted(tp) == _jlifted(jp) == [f"/layers/attn/{w}" for w in
                                           ("w_k", "w_o", "w_q", "w_v")]
    assert tn == jn == 4
    for name in ("moe_gate", "moe_up", "moe_down"):
        leaf = tp["layers"]["moe"][name]
        assert isinstance(leaf, torch.Tensor) and leaf.ndim == 4


def test_expert_ffn_plans_one_grouped_key_per_projection_shape():
    """Auto mode plans the expert FFN under grouped keys (``|gE×``), one per
    projection shape (d, ff) and (ff, d): not E per-expert keys (reference
    ``tests/test_grouped.py::test_moe_expert_ffn_is_grouped_planned``)."""
    p, x, k, cf = _layer("tiny")
    tcache.reset()
    try:
        with tfalcon.use(TConfig(use_plan_cache=True)):
            tmoe.moe_apply(_tree_t(p), _t(x), top_k=k, capacity_factor=cf)
        grouped = [key for key in tcache.default_cache().keys() if "|g4x" in key]
        assert len(grouped) == 2, grouped
    finally:
        tcache.reset()


def _fields(c):
    return (c.kind, c.role, c.key_shape(), c.group, c.shared_b, c.weight_static)


ENGINE_POLICY = BucketPolicy.build(64, 8)


def _contexts():
    out = [(4, 512, {}), (1, 2048, {}), (8, 1, dict(decode=True, kv_len=128)),
           (4, 3, dict(kv_len=128, spec_verify=True))]
    out += [(b, s, dict(kv_len=128)) for b, s in ENGINE_POLICY.prefill_shapes()]
    out += [(b, 1, dict(kv_len=128, decode=True)) for b in ENGINE_POLICY.decode_batch]
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_workloads_match_reference(arch):
    """The MoE registry entries (grouped expert specs in place of the dense
    MLP, the router unplanned), the capacity (plain and shard-rounded) and
    the resolved inventory at prefill, decode, a verify step and every
    bucket of the engine's grid: the reference's, key for key."""
    spec = ("kind", "role", "m", "k", "n", "group", "shared_b", "weight_static")
    assert [tuple(getattr(s, f) for f in spec) for s in twl.contraction_set(arch)] == \
        [tuple(getattr(s, f) for f in spec) for s in jwl.contraction_set(arch)]
    assert [s.role for s in twl.contraction_set(arch, quantize=True)] == \
        [s.role for s in jwl.contraction_set(arch, quantize=True)]
    cfg = treg.get_config(arch)
    for T in (1, 4, 8, 64, 160, 512, 600, 2048, 4096, 8192):
        for cf in (1.0, 1.25, 2.0):
            for sr in (False, True):
                args = (T, cfg.experts_per_token, cfg.num_experts, cf)
                assert twl.moe_capacity(*args, shard_round=sr) == \
                    jwl.moe_capacity(*args, shard_round=sr), (T, cf, sr)
        assert twl.grouped_moe_shapes(arch, T) == jwl.grouped_moe_shapes(arch, T), T
    for batch, seq, kw in _contexts():
        got = [_fields(c) for c in twl.resolve_contractions(arch, batch, seq, **kw)]
        want = [_fields(c) for c in jwl.resolve_contractions(arch, batch, seq, **kw)]
        assert got == want, (batch, seq, kw)
        assert any(c[0] == "grouped_moe" for c in got)
    assert twl.dense_projection_shapes(arch) == jwl.dense_projection_shapes(arch)
    assert twl.warm_shapes(arch) == jwl.warm_shapes(arch)
    # dbrx at the one-shot prefill (4 x 512 rows), a 512-row bucket, decode
    E, k = cfg.num_experts, cfg.experts_per_token
    caps = {T: twl.moe_capacity(T, k, E, cfg.capacity_factor, shard_round=True)
            for T in (2048, 512, 4)}
    if arch == "dbrx_132b":
        assert caps == {2048: 768, 512: 160, 4: 8}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_matches_reference(arch):
    """Every field of the port's ModelConfig (the MoE ones among them) in the
    full config and both smoke configs; the backend default is the port's
    own ("cuda")."""
    fields = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "falcon_backend"]
    for get in ("get_config", "smoke_config", "lcma_smoke_config"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}, get
        assert (t.falcon_backend, j.falcon_backend) == ("cuda", "jnp")
    assert treg.get_config(arch.replace("_", "-")) is treg.get_config(arch)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_tree_and_conversion_match_reference(arch):
    """The port's ``init_params`` tree has the reference's keys and shapes
    (``layers/moe/{router (L, d, E), moe_gate, moe_up (L, E, d, ff),
    moe_down (L, E, ff, d)}`` in place of ``mlp``), and
    ``params_from_numpy`` carries the reference's weights across exactly."""
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = _flat(TM.init_params(cfg, 0, device="cpu"))
    conv = _flat(params_from_numpy(jparams, cfg, device="cpu"))
    ref = _flat(jparams)
    assert sorted(mine) == sorted(conv) == sorted(ref)
    assert "layers/moe/moe_gate" in ref and not any("mlp" in k for k in ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape == tuple(conv[k].shape), k
        np.testing.assert_array_equal(conv[k].numpy(), v)
    L, E, d, ff = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert mine["layers/moe/router"].shape == (L, d, E)
    assert mine["layers/moe/moe_down"].shape == (L, E, ff, d)


def test_init_params_draws_one_expert_at_a_time(monkeypatch):
    """A 4-D expert stack is drawn one (layer, expert) slice at a time: the
    float32 transient is one expert, and the values are those of one
    float32 draw of each whole leaf (the CPU generator's stream is consumed
    in order). The dense leaves' draws are unchanged."""
    cfg = dataclasses.replace(treg.smoke_config("dbrx_132b"), num_layers=3)
    monkeypatch.setattr(TM, "_EMBED_ROWS", 100)
    drawn, real_randn = [], torch.randn

    def randn(*a, **kw):
        out = real_randn(*a, **kw)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", randn)
    params = TM.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch, "randn", real_randn)
    gen = torch.Generator().manual_seed(0)
    Lc, d, hd, E, ff = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim, \
        cfg.num_experts, cfg.d_ff

    def whole(*s):
        return torch.randn(s, generator=gen, dtype=torch.float32) / math.sqrt(s[-2])

    old = {"w_q": whole(Lc, d, cfg.num_heads * hd), "w_k": whole(Lc, d, cfg.num_kv_heads * hd),
           "w_v": whole(Lc, d, cfg.num_kv_heads * hd), "w_o": whole(Lc, cfg.num_heads * hd, d),
           "router": whole(Lc, d, E), "moe_gate": whole(Lc, E, d, ff),
           "moe_up": whole(Lc, E, d, ff), "moe_down": whole(Lc, E, ff, d)}
    leaves = {**params["layers"]["attn"], **params["layers"]["moe"]}
    for name, w in leaves.items():
        assert torch.equal(w, old[name]), name
    assert max(drawn) == d * ff                 # one expert of one layer


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
        prefill = jax.jit(make_prefill_step(cfg, max_len=S + GEN))
        decode = jax.jit(make_decode_step(cfg))
        lg, cache = prefill(planned, jnp.asarray(prompts, jnp.int32))
        for i in range(GEN):
            logits.append(np.asarray(lg[:, -1]))
            nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
            tokens.append(np.asarray(nxt))
            if i + 1 < GEN:
                lg, cache = decode(planned, cache, nxt[:, None], S + i)
    return jax.tree.map(np.asarray, params), logits, np.stack(tokens, 1), n_pre


B, S, GEN = 2, 16, 5            # prefill + 4 decode steps


@pytest.fixture(scope="module", params=[(a, m) for a in MOE_ARCHS for m in MODES],
                ids=lambda c: "-".join(c))
def model_pair(request):
    arch, mode = request.param
    np_params, logits, tokens, n_pre = _reference_run(arch, mode)
    cfg = dataclasses.replace(treg.smoke_config(arch), falcon_mode=mode)
    res = run_oneshot(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device="cpu",
                      params=params_from_numpy(np_params, cfg, device="cpu"))
    return (arch, mode), (logits, tokens, n_pre), res


def test_model_logits_match_reference(model_pair):
    case, (logits, _, _), res = model_pair
    assert len(res["logits"]) == len(logits) == GEN
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{case} step {step}", **TOL)


def test_model_tokens_and_precombine_match_reference(model_pair):
    (_, mode), (_, tokens, n_pre), res = model_pair
    np.testing.assert_array_equal(res["tokens"].numpy(), tokens)
    assert res["n_precombined"] == n_pre == {"gemm": 0, "strassen": 4}[mode]


def test_eager_expert_ffn_is_the_per_expert_product():
    """The plain version, in f32 on bf16 inputs, against numpy's per-expert
    product (``compute_dtype`` is the arithmetic; the result rounds once)."""
    p, x, k, cf = _layer("tiny")
    xb = _t(np.random.default_rng(2).standard_normal((4, 8, 16))).to(torch.bfloat16)
    w = [_t(p[n]).to(torch.bfloat16) for n in ("moe_gate", "moe_up", "moe_down")]
    got = eager_expert_ffn(*w, xb, compute_dtype=torch.float32)
    xs, (g, u, dn) = xb.float().numpy(), (t.float().numpy() for t in w)
    h = xs @ g
    want = ((h / (1 + np.exp(-h))) * (xs @ u)) @ dn
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_family_gate():
    """The port's model and registry take all six of the reference's
    families; a family outside them raises, naming the ones the port runs."""
    other = dataclasses.replace(treg.smoke_config("granite_3_2b"), family="diffusion",
                                name="x")
    with pytest.raises(NotImplementedError, match="unknown family 'diffusion'"):
        TM.init_params(other, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown family 'diffusion'"):
        twl.contraction_set(other)
    for arch in treg.list_archs():
        assert twl.contraction_set(treg.smoke_config(arch))
