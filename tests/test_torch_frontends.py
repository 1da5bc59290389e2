"""The audio and vlm frontends in the port, against the reference, on the CPU.

``musicgen_large`` (audio: four codebook token streams whose embeddings are
summed, one LM head per codebook, logits (B, S, CB, Vp)) and
``pixtral_12b`` (vlm: precomputed patch embeddings prepended to the text).
Same numpy inputs, made from a seed, through both packages: the reference
runs its generated ``"jnp"`` backend (its Pallas kernels in interpret mode
for the int8 tier), the port its kernels' plain versions.

* Configs (full, smoke, lcma smoke) field for field; the parameter tree and
  its conversion; ``_embed_tokens`` in bf16 (the codebook sum's order and
  rounding) and with patches.
* Prefill and decode logits and greedy tokens through ``run_oneshot`` in
  gemm and forced strassen, at f32 rtol/atol 1e-4 (``test_torch_archs``);
  the reference is driven as its launcher drives it, with the cache sized
  ``P + num_patches + GEN``. musicgen's int8 tier at ``lcma_smoke_config``
  within ``test_torch_quant``'s QUANT_TOL.
* ``precombine_params``: the same count, and the codebook ``lm_head``
  lifted as one stacked PlannedWeight that slices per codebook (B̃, B̃q,
  scales).
* The workload registry: the reference's contraction set, warm shapes and
  projection shapes; patches counted in a prefill's rows.
* ``ServeEngine`` refuses both families, as the reference's does.
* The reference launcher's vlm cache is short by ``num_patches`` (decode
  overwrites its last slot); the port sizes it right. Pinned token lists.
* The CLI serves both archs on the CPU.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.configs import registry as jreg
from repro.core import workloads as jwl
from repro.core.engine import PlannedWeight as JPlannedWeight
from repro.models import model as JM
from repro.serve import ServeEngine as JServeEngine
from repro.train.steps import make_decode_step as j_decode_step
from repro.train.steps import make_prefill_step as j_prefill_step
import repro_torch.api as tfalcon
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import workloads as twl
from repro_torch.core.falcon_gemm import precombine_weights
from repro_torch.core.lcma import LCMA
from repro_torch.core import algorithms as talg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine as TServeEngine

from test_torch_quant import QUANT_TOL, _normalized

ARCHS = ["musicgen_large", "pixtral_12b"]
MODES = ("gemm", "strassen")
TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_torch_archs.py
B, S, GEN = 2, 8, 5


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _tflat(v, f"{path}/{k}" if path else k).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    fields = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "falcon_backend"]
    for get in ("get_config", "smoke_config", "lcma_smoke_config"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}, get
        assert (t.falcon_backend, j.falcon_backend) == ("cuda", "jnp")
    assert treg.smoke_config("pixtral_12b").num_patches == 8
    assert (treg.get_config("musicgen_large").frontend,
            treg.get_config("pixtral_12b").frontend) == ("audio_codebooks", "vision_patches")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_conversion_match_reference(arch):
    """The same leaves and shapes (musicgen: ``embed`` (CB, Vp, d), an
    untied ``lm_head`` (CB, d, Vp), the two-matrix gelu MLP); the
    conversion carries the reference's weights exactly; init's scales
    (embed 0.02, head 1/sqrt(d)) as the reference draws them."""
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = _tflat(TM.init_params(cfg, 0, device="cpu"))
    conv = _tflat(params_from_numpy(jparams, cfg, device="cpu"))
    ref = _flat(jparams)
    assert sorted(mine) == sorted(conv) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape == tuple(conv[k].shape), k
        np.testing.assert_array_equal(conv[k].numpy(), v)
    Vp, d = TM.padded_vocab(cfg), cfg.d_model
    if arch == "musicgen_large":
        assert mine["embed"].shape == (4, Vp, d) and mine["lm_head"].shape == (4, d, Vp)
        assert "layers/mlp/mlp_gate" not in mine
        full = TM.init_params(dataclasses.replace(cfg, d_model=256, vocab_size=2048), 0,
                              device="cpu")
        assert float(full["embed"].std()) == pytest.approx(0.02, rel=0.02)
        assert float(full["lm_head"].std()) == pytest.approx(256 ** -0.5, rel=0.02)
    else:
        assert mine["embed"].shape == (Vp, d) and "lm_head" not in mine


def test_audio_embedding_sums_codebooks_as_the_reference_in_bf16():
    jcfg = dataclasses.replace(jreg.smoke_config("musicgen_large"), dtype="bfloat16")
    cfg = dataclasses.replace(treg.smoke_config("musicgen_large"), dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg,
                           device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks))
    want = JM._embed_tokens(jp, jcfg, jnp.asarray(toks))
    got = TM._embed_tokens(tp, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the sum rounds after each codebook: not the f32 sum rounded once
    once = sum(tp["embed"][c][torch.from_numpy(toks[..., c])].float()
               for c in range(cfg.num_codebooks)).bfloat16()
    assert not torch.equal(once, got)


def test_vlm_embedding_prepends_patches():
    jcfg = dataclasses.replace(jreg.smoke_config("pixtral_12b"), dtype="bfloat16")
    cfg = dataclasses.replace(treg.smoke_config("pixtral_12b"), dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg,
                           device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    pe = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    want = JM._embed_tokens(jp, jcfg, jnp.asarray(toks), jnp.asarray(pe))
    got = TM._embed_tokens(tp, cfg, torch.from_numpy(toks), torch.from_numpy(pe))
    assert tuple(got.shape) == want.shape == (B, cfg.num_patches + S, cfg.d_model)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(TM._embed_tokens(tp, cfg, torch.from_numpy(toks)),
                       got[:, cfg.num_patches:])


# ---------------------------------------------------------------------------
# Serving, one-shot
# ---------------------------------------------------------------------------

def _reference_run(cfg, gen: int, max_len: int, batch=B, prompt_len=S, fcfg=None):
    """The reference's one-shot path as its launcher drives it (tokens, then
    patches, from ``default_rng(0)``; the audio argmax fed back as (B, 1,
    CB)), on its seed-0 weights with the cache sized ``max_len``: (params
    as numpy, last-position logits per step, greedy tokens, n_precombined,
    the planned tree)."""
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    audio = cfg.frontend == "audio_codebooks"
    shape = (batch, prompt_len, cfg.num_codebooks) if audio else (batch, prompt_len)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, shape), jnp.int32)
    extra, pos0 = (), prompt_len
    if cfg.frontend == "vision_patches":
        extra = (jnp.asarray(rng.standard_normal((batch, cfg.num_patches, cfg.d_model)),
                             jnp.dtype(cfg.dtype)),)
        pos0 += cfg.num_patches
    logits, out = [], []
    with jfalcon.use(fcfg or JM.falcon_config_for(cfg)):
        planned, n_pre = jfalcon.precombine_params(params, m_hint=batch * prompt_len)
        lg, cache = jax.jit(j_prefill_step(cfg, max_len=max_len))(planned, tokens, *extra)
        decode = jax.jit(j_decode_step(cfg))
        for i in range(gen):
            logits.append(np.asarray(lg[:, -1]))
            nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
            out.append(np.asarray(nxt))
            if i + 1 < gen:
                lg, cache = decode(planned, cache, nxt[:, None], pos0 + i)
    return jax.tree.map(np.asarray, params), logits, np.stack(out, 1), n_pre, planned


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda c: "-".join(c))
def pair(request):
    arch, mode = request.param
    jcfg = dataclasses.replace(jreg.smoke_config(arch), falcon_mode=mode,
                               falcon_backend="jnp")
    np_params, logits, tokens, n_pre, _ = _reference_run(
        jcfg, GEN, max_len=S + jcfg.num_patches * (arch == "pixtral_12b") + GEN)
    cfg = dataclasses.replace(treg.smoke_config(arch), falcon_mode=mode)
    res = tlaunch.run_oneshot(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device="cpu",
                              params=params_from_numpy(np_params, cfg, device="cpu"))
    return (arch, mode), (logits, tokens, n_pre), res


def test_logits_match_reference(pair):
    (arch, mode), (logits, _, _), res = pair
    assert len(res["logits"]) == len(logits) == GEN
    Vp = TM.padded_vocab(treg.smoke_config(arch))
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        assert tuple(got.shape) == ((B, 4, Vp) if arch == "musicgen_large" else (B, Vp))
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{arch} {mode} {step}", **TOL)


def test_tokens_and_precombine_match_reference(pair):
    (arch, mode), (_, tokens, n_pre), res = pair
    assert res["tokens"].shape == ((B, GEN, 4) if arch == "musicgen_large" else (B, GEN))
    np.testing.assert_array_equal(res["tokens"].numpy(), tokens)
    # w_q, w_k, w_v, w_o, the MLP's two or three, musicgen's codebook head
    leaves = {"musicgen_large": 7, "pixtral_12b": 7}[arch]
    assert res["n_precombined"] == n_pre == {"gemm": 0, "strassen": leaves}[mode]


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "int8"])
def test_codebook_head_is_one_stacked_planned_weight(quantize):
    """Forced strassen lifts musicgen's (CB, d, Vp) head as ONE stacked
    (not grouped) PlannedWeight, as the reference does; ``pw[c]`` is
    codebook c's B̃ (and B̃q, scales), and its dense equals planning that
    codebook's head alone."""
    cfg = dataclasses.replace(treg.lcma_smoke_config("musicgen_large"),
                              falcon_mode="strassen")
    jcfg = dataclasses.replace(jreg.lcma_smoke_config("musicgen_large"),
                               falcon_mode="strassen", falcon_backend="jnp")
    params = TM.init_params(cfg, 0, device="cpu")
    fcfg = dataclasses.replace(TM.falcon_config_for(cfg), quantize=quantize)
    with tfalcon.use(fcfg):
        planned, n = tfalcon.precombine_params(params, m_hint=B * S)
        head = planned["lm_head"]
        x = torch.randn((B, 3, cfg.d_model), generator=torch.Generator().manual_seed(0))
        for c in range(cfg.num_codebooks):
            one = tfalcon.plan_weight(params["lm_head"][c], m_hint=B * S)
            assert torch.equal(head[c].bt, one.bt)
            assert torch.equal(head[c].bt, precombine_weights(params["lm_head"][c],
                                                              talg.get("strassen")))
            if quantize:
                assert torch.equal(head[c].bq, one.bq)
                assert torch.equal(head[c].b_scales, one.b_scales)
            assert torch.equal(tfalcon.dense(x, head[c]), tfalcon.dense(x, one))
    assert isinstance(head, tfalcon.PlannedWeight) and head.algo == "strassen"
    assert head.bt.shape[0] == cfg.num_codebooks and head.quantized == quantize
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    with jfalcon.use(dataclasses.replace(JM.falcon_config_for(jcfg), quantize=quantize)):
        jplanned, jn = jfalcon.precombine_params(jparams, m_hint=B * S)
    assert isinstance(jplanned["lm_head"], JPlannedWeight)
    assert jplanned["lm_head"].bt.shape == tuple(head.bt.shape)
    assert n == jn


def test_musicgen_int8_matches_reference():
    """musicgen at ``lcma_smoke_config``, forced strassen with the int8 tier
    (the reference's Pallas kernels in interpret mode), within
    ``tests/test_torch_quant.py``'s QUANT_TOL."""
    gen = 3
    jcfg = dataclasses.replace(jreg.lcma_smoke_config("musicgen_large"),
                               falcon_mode="strassen", falcon_backend="pallas_interpret")
    fcfg = dataclasses.replace(JM.falcon_config_for(jcfg), quantize=True)
    np_params, logits, tokens, n_pre, planned = _reference_run(jcfg, gen, S + gen, fcfg=fcfg)
    n_q = sum(isinstance(x, JPlannedWeight) and x.quantized for x in jax.tree_util.tree_leaves(
        planned, is_leaf=lambda x: isinstance(x, JPlannedWeight)))
    cfg = dataclasses.replace(treg.lcma_smoke_config("musicgen_large"),
                              falcon_mode="strassen")
    res = tlaunch.run_oneshot(cfg, batch=B, prompt_len=S, gen=gen, seed=0, device="cpu",
                              params=params_from_numpy(np_params, cfg, device="cpu"),
                              quantize=True)
    assert res["n_precombined"] == n_pre == 7 and res["n_quantized"] == n_q == 7
    assert "lm_head" in res["quantized"]
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        assert _normalized(got, want) <= QUANT_TOL, step
    np.testing.assert_array_equal(res["tokens"][:, 0].numpy(), tokens[:, 0])


# ---------------------------------------------------------------------------
# The workload registry
# ---------------------------------------------------------------------------

def _fields(c):
    return (c.kind, c.role, c.m, c.k, c.n, c.group, c.shared_b, c.weight_static)


@pytest.mark.parametrize("arch", ARCHS)
def test_contractions_match_reference(arch):
    """The contraction set (musicgen's one (d, Vp) head spec, run once per
    codebook), warm and projection shapes equal the reference's; a prefill
    context counts pixtral's patches in its rows as the reference does. A
    decode step carries no patches: there the port counts B rows where the
    reference counts B * (1 + num_patches)."""
    spec = ("kind", "role", "m", "k", "n", "group", "shared_b", "weight_static")
    assert [tuple(getattr(s, f) for f in spec) for s in twl.contraction_set(arch)] == \
        [tuple(getattr(s, f) for f in spec) for s in jwl.contraction_set(arch)]
    assert [s.role for s in twl.contraction_set(arch)].count("lm_head") == 1
    for batch, seq, kw in ((4, 512, {}), (1, 2048, {}), (4, 512, dict(kv_len=1560))):
        got = [_fields(c) for c in twl.resolve_contractions(arch, batch, seq, **kw)]
        want = [_fields(c) for c in jwl.resolve_contractions(arch, batch, seq, **kw)]
        assert got == want, (batch, seq, kw)
    rows = {c.role: c.m for c in twl.resolve_contractions(arch, 4, 512)}
    assert rows["attn.w_q"] == 4 * (512 + (1024 if arch == "pixtral_12b" else 0))
    dec = twl.resolve_contractions(arch, 4, 1, decode=True, kv_len=1560)
    assert {c.m for c in dec if c.kind == "dense"} == {4}
    assert twl.dense_projection_shapes(arch) == jwl.dense_projection_shapes(arch)
    assert twl.warm_shapes(arch) == jwl.warm_shapes(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_frontends_like_the_reference(arch):
    with pytest.raises(NotImplementedError) as want:
        JServeEngine(jreg.smoke_config(arch))
    with pytest.raises(NotImplementedError) as got:
        TServeEngine(treg.smoke_config(arch), device="cpu")
    assert str(got.value) == str(want.value)
    assert "frontend=" in str(got.value)


# ---------------------------------------------------------------------------
# The reference launcher's vlm cache
# ---------------------------------------------------------------------------

# smoke pixtral (8 patches), one 8-token prompt, 12 greedy tokens, seed 0
CLAMPED = [60, 98, 212, 28, 239, 142, 69, 83, 228, 16, 226, 54]     # cache P + gen
SIZED = [60, 98, 212, 28, 239, 142, 69, 219, 51, 226, 226, 28]      # cache P + 8 + gen


def test_vlm_cache_counts_the_patches():
    """The reference's launcher sizes the vlm cache ``prompt_len + gen``,
    8 short of what prefill and decode write: decode's clamped writes
    overwrite the last slot from step 8 on and the tokens part. The port's
    ``run_oneshot`` sizes it ``prompt_len + num_patches + gen`` and gives
    the reference's tokens under that cache."""
    gen, P = 12, 8
    jcfg = dataclasses.replace(jreg.smoke_config("pixtral_12b"), falcon_backend="jnp")
    _, _, short, _, _ = _reference_run(jcfg, gen, P + gen, batch=1, prompt_len=P)
    np_params, _, sized, _, _ = _reference_run(jcfg, gen, P + 8 + gen, batch=1,
                                               prompt_len=P)
    assert short[0].tolist() == CLAMPED and sized[0].tolist() == SIZED
    cfg = treg.smoke_config("pixtral_12b")
    res = tlaunch.run_oneshot(cfg, batch=1, prompt_len=P, gen=gen, seed=0, device="cpu",
                              params=params_from_numpy(np_params, cfg, device="cpu"))
    assert res["tokens"][0].tolist() == SIZED


def test_launcher_serves_the_frontends_on_cpu(capsys):
    for arch in ARCHS:
        tlaunch.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
        out = capsys.readouterr().out
        assert "prefill:" in out and "sample:" in out, arch
    tlaunch.main(["--arch", "musicgen_large", "--device", "cpu", "--batch", "1",
                  "--prompt-len", "4", "--gen", "2", "--quant"])
    out = capsys.readouterr().out
    assert "with int8 B̃q" in out and "sample:" in out
    with pytest.raises(NotImplementedError, match="frontend"):
        tlaunch.main(["--arch", "pixtral_12b", "--device", "cpu", "--continuous",
                      "--requests", "2"])


# ---------------------------------------------------------------------------
# the tanh GELU (musicgen's and starcoder2's MLP) in bf16
# ---------------------------------------------------------------------------

def test_bf16_gelu_rounds_as_jax():
    """``models.layers.gelu`` on every finite bf16 value in [-10, 10]
    against ``jax.nn.gelu``: equal bit for bit on all but the values whose
    result is subnormal (|x| < 2^-125), which the reference's XLA on the
    CPU flushes to zero. Those differ from it by at most 2^-126, the
    smallest normal: one ulp of a format that flushes, the gap at zero.
    ``F.gelu(approximate="tanh")``, which rounds once, moves ~1,500 values.
    In float32 the port's GELU is ``F.gelu`` itself."""
    import ml_dtypes
    from repro_torch.models.layers import gelu

    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    xs = np.unique(vals[np.isfinite(vals) & (np.abs(vals) <= 10)])
    want = np.asarray(jax.nn.gelu(jnp.asarray(xs, jnp.bfloat16))).astype(np.float32)
    x = torch.tensor(xs, dtype=torch.bfloat16)
    got = gelu(x).float().numpy()
    differ = got != want
    tiny = 2.0 ** -126
    assert differ.sum() <= 512, int(differ.sum())
    assert (np.abs(xs[differ]) < 2 * tiny).all() and (want[differ] == 0).all()
    assert (np.abs(got[differ]) <= tiny).all()
    once = torch.nn.functional.gelu(x, approximate="tanh").float().numpy()
    assert (once != want).sum() > 1000
    xf = torch.tensor(xs)
    assert torch.equal(gelu(xf), torch.nn.functional.gelu(xf, approximate="tanh"))


def test_bf16_gelu_mlp_layer_matches_reference():
    """A starcoder2-shaped bf16 GELU MLP (its 1 : 4 ratio of d_model to
    d_ff, at a quarter of its width: 1536 x 6144) on 64 rows, gemm, one
    numpy f32 weight set cast to each dtype: as
    ``tests/test_torch_ssm.py::test_bf16_rounding_matches_reference``
    allows, the port's bf16 output sits no further from its f32 output than
    1.5x the reference's own bf16-vs-f32 gap, and no further from the
    reference's bf16 output than that gap; in f32 the packages agree within
    1e-4 (relative, max |diff| / max |ref|)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    d, ff = 1536, 6144
    rng = np.random.default_rng(0)
    p = {"mlp_up": (rng.standard_normal((d, ff)) / np.sqrt(d)).astype(np.float32),
         "mlp_down": (rng.standard_normal((ff, d)) / np.sqrt(ff)).astype(np.float32)}
    h = rng.standard_normal((1, 64, d)).astype(np.float32)

    def ref(dtype):
        with jfalcon.use(jfalcon.FalconConfig(mode="gemm", backend="jnp")):
            f = jax.jit(lambda pp, x: JL.mlp_apply(pp, x))
            out = f({k: jnp.asarray(v, dtype) for k, v in p.items()}, jnp.asarray(h, dtype))
        return np.asarray(out, np.float32)

    def port(dtype):
        dt = getattr(torch, dtype)
        with tfalcon.use(tfalcon.FalconConfig(mode="gemm")):
            out = TL.mlp_apply({k: torch.tensor(v, dtype=dt) for k, v in p.items()},
                               torch.tensor(h, dtype=dt))
        return out.float().numpy()

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    r32, r16, t32, t16 = ref("float32"), ref("bfloat16"), port("float32"), port("bfloat16")
    gap = rel(r16, r32)
    assert rel(t32, r32) < 1e-4
    assert rel(t16, t32) <= 1.5 * gap, (rel(t16, t32), gap)
    assert rel(t16, r16) <= gap, (rel(t16, r16), gap)
