"""The reference's other dense architectures in the port, on the CPU.

``mistral_nemo_12b`` (q width 4096 != d_model 5120), ``starcoder2_15b``
(the two-matrix gelu MLP) and ``gemma3_27b`` (five sliding-window layers
per global one): each config equals the reference's field for field, the
contraction inventory is the reference's at prefill and decode, and on
``lcma_smoke_config`` (2 layers, d_model 256) the same weights (the
reference's ``init_params`` tree through ``convert.params_from_numpy``)
give the reference's logits and greedy tokens in forced strassen, auto
mode (the profile of ``tests/test_torch_model.py``) and gemm, at f32
rtol/atol 1e-4 (the same scheme, matmul sums in another order). The
reference runs its default generated ``"jnp"`` backend; the port runs its
``"cuda"`` kernels' plain versions, and starcoder2 once more on the
generated ``"torch"`` backend. gemma3's prefill is longer than the smoke
window (32) and its decode steps go past it. Last, ``init_params`` draws a
stacked leaf one layer slice at a time: the same values as one float32
draw of the whole leaf, in less memory.
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
from repro.core import hardware as jhw, workloads as jwl
from repro.models import model as JM
from repro.train.steps import make_decode_step, make_prefill_step
import repro_torch.api as tfalcon
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import hardware as thw, workloads as twl
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as TM

from test_torch_model import AUTO_CANDIDATES, PROFILE, TOL

NEW_ARCHS = ["mistral_nemo_12b", "starcoder2_15b", "gemma3_27b"]
B, GEN = 2, 5
# prompt length: gemma3's exceeds its smoke window (32), and the decode steps
# run past it, so its local layer masks keys the global one sees
PROMPT = {"mistral_nemo_12b": 16, "starcoder2_15b": 16, "gemma3_27b": 40}
CASES = [(a, m, "cuda") for a in NEW_ARCHS for m in ("strassen", "auto", "gemm")] + [
    ("starcoder2_15b", "auto", "torch")]


def test_registry_lists_the_dense_archs():
    assert sorted(treg.list_archs()) == sorted(
        ["granite_3_2b", "mistral_nemo_12b", "starcoder2_15b", "gemma3_27b"])
    assert set(treg.list_archs()) <= set(jreg.list_archs())
    assert treg.get_config("gemma3-27b") is treg.get_config("gemma3_27b")
    with pytest.raises(KeyError, match="the port runs"):
        treg.get_config("mamba2_370m")


@pytest.mark.parametrize("arch", ["granite_3_2b"] + NEW_ARCHS)
def test_config_matches_reference(arch):
    """Every field of the port's ModelConfig, in the full config and both
    smoke configs; the backend default is the port's own ("cuda", the
    reference's is "jnp")."""
    fields = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "falcon_backend"]
    for get in ("get_config", "smoke_config", "lcma_smoke_config"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}, get
        assert t.layer_windows() == j.layer_windows()
        assert (t.falcon_backend, j.falcon_backend) == ("cuda", "jnp")
    full = treg.get_config(arch)
    assert TM.padded_vocab(full) == JM.padded_vocab(jreg.get_config(arch))


def _fields(c):
    return (c.kind, c.role, c.m, c.k, c.n, c.group, c.shared_b, c.weight_static)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_contractions_match_reference(arch):
    spec = ("kind", "role", "m", "k", "n", "group", "shared_b", "weight_static")
    assert [tuple(getattr(s, f) for f in spec) for s in twl.contraction_set(arch)] == \
        [tuple(getattr(s, f) for f in spec) for s in jwl.contraction_set(arch)]
    for batch, seq, kw in ((4, 512, {}), (1, 2048, {}), (8, 1, dict(decode=True, kv_len=128)),
                           (4, 3, dict(decode=True, kv_len=64, spec_verify=True))):
        got = [_fields(c) for c in twl.resolve_contractions(arch, batch, seq, **kw)]
        want = [_fields(c) for c in jwl.resolve_contractions(arch, batch, seq, **kw)]
        assert got == want, (batch, seq, kw)
        assert [c.key_shape() for c in twl.resolve_contractions(arch, batch, seq, **kw)] == \
            [c.key_shape() for c in jwl.resolve_contractions(arch, batch, seq, **kw)]
    assert twl.dense_projection_shapes(arch) == jwl.dense_projection_shapes(arch)
    assert twl.warm_shapes(arch) == jwl.warm_shapes(arch)


def _reference(arch: str, mode: str, backend: str):
    """Reference run on its generated "jnp" backend: (params as numpy,
    last-position logits per step, greedy tokens, n_precombined). Against
    the port's "torch" backend, whose H reaches memory, it prices the
    unfused pipeline (``fused=False``; the smoke configs are f32, where both
    packages price H alike)."""
    S = PROMPT[arch]
    cfg = dataclasses.replace(jreg.lcma_smoke_config(arch), falcon_mode=mode,
                              falcon_backend="jnp")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    fcfg = JM.falcon_config_for(cfg)
    if mode == "auto":
        jhw.register_profile(jhw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES, fused=backend != "torch")
    logits, tokens = [], []
    with jfalcon.use(fcfg):
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
    return (jax.tree.map(np.asarray, params), logits, np.stack(tokens, 1), n_pre)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def pair(request):
    arch, mode, backend = request.param
    np_params, logits, tokens, n_pre = _reference(arch, mode, backend)
    cfg = dataclasses.replace(treg.lcma_smoke_config(arch), falcon_mode=mode,
                              falcon_backend=backend)
    params = params_from_numpy(np_params, cfg, device="cpu")
    fcfg = TM.falcon_config_for(cfg)
    if mode == "auto":
        thw.register_profile(thw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES)
    with tfalcon.use(fcfg):
        res = run_oneshot(cfg, batch=B, prompt_len=PROMPT[arch], gen=GEN, seed=0,
                          device="cpu", params=params)
    return (arch, mode, backend), (logits, tokens, n_pre), res


def test_logits_match_reference(pair):
    case, (logits, _, _), res = pair
    assert len(res["logits"]) == len(logits) == GEN
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{case} step {step}", **TOL)


def test_greedy_tokens_and_precombine_match_reference(pair):
    (arch, mode, _), (_, tokens, n_pre), res = pair
    np.testing.assert_array_equal(res["tokens"].numpy(), tokens)
    assert res["n_precombined"] == n_pre
    leaves = 6 if treg.get_config(arch).mlp_type == "gelu" else 7
    if mode == "auto":
        assert 0 < n_pre <= leaves    # the profile makes LCMAs win at the prefill M
    else:
        assert n_pre == {"gemm": 0, "strassen": leaves}[mode]


def test_gemma3_window_masks_the_local_layer():
    """The smoke gemma3 has one local (window 32) and one global layer: past
    the window, the local layer's output depends on the window, so the
    decode logits differ from a run with every layer global."""
    cfg = dataclasses.replace(treg.lcma_smoke_config("gemma3_27b"), falcon_mode="gemm")
    assert cfg.layer_windows() == [32, 0]
    params = TM.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 48)))
    local, _ = TM.forward(params, cfg, toks, logits_mode="all")
    flat, _ = TM.forward(params, dataclasses.replace(cfg, sliding_window=0), toks,
                         logits_mode="all")
    torch.testing.assert_close(local[:, :32], flat[:, :32], rtol=1e-5, atol=1e-5)
    assert (local[:, 33:] - flat[:, 33:]).abs().max() > 1e-3


def _whole_leaf_draw(cfg: ModelConfig, seed: int) -> dict:
    """``init_params``' numbers drawn the old way, each stacked leaf (and the
    embedding) as one float32 tensor: the reference the per-slice draw is
    held to."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)

    def dense(*s):
        w = torch.randn(s, generator=gen, dtype=torch.float32)
        return (w / math.sqrt(s[-2])).to(dt)

    Lc, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    out = {"w_q": dense(Lc, d, cfg.num_heads * hd), "w_k": dense(Lc, d, cfg.num_kv_heads * hd),
           "w_v": dense(Lc, d, cfg.num_kv_heads * hd), "w_o": dense(Lc, cfg.num_heads * hd, d)}
    names = ("mlp_up", "mlp_down") if cfg.mlp_type == "gelu" else \
        ("mlp_gate", "mlp_up", "mlp_down")
    for name in names:
        out[name] = dense(Lc, cfg.d_ff, d) if name == "mlp_down" else dense(Lc, d, cfg.d_ff)
    out["embed"] = (torch.randn((TM.padded_vocab(cfg), d), generator=gen) * 0.02).to(dt)
    return out


@pytest.mark.parametrize("arch", ["granite_3_2b"] + NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_per_slice_draw(arch, dtype, monkeypatch):
    """Shapes and dtypes as the reference's ``init_params``; the values those
    of one float32 draw of each whole leaf (the CPU generator's stream is
    consumed in order), so their statistics too; the float32 transient one
    layer slice (one embedding block)."""
    cfg = dataclasses.replace(treg.lcma_smoke_config(arch), dtype=dtype, num_layers=3)
    monkeypatch.setattr(TM, "_EMBED_ROWS", 100)       # several embedding blocks
    drawn = []
    real_randn = torch.randn

    def randn(*a, **kw):
        out = real_randn(*a, **kw)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", randn)
    params = TM.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch, "randn", real_randn)
    jshapes = jax.eval_shape(lambda: JM.init_params(
        dataclasses.replace(jreg.lcma_smoke_config(arch), dtype=dtype, num_layers=3),
        jax.random.PRNGKey(0)))
    flat_t = {"/".join(map(str, k)): v for k, v in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    flat_j = {"/".join(map(str, k)): v for k, v in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert sorted(flat_t) == sorted(flat_j)
    for k, t in flat_t.items():
        assert tuple(t.shape) == flat_j[k].shape and str(t.dtype) == f"torch.{dtype}", k
    old = _whole_leaf_draw(cfg, 0)
    leaves = {**params["layers"]["attn"], **params["layers"]["mlp"], "embed": params["embed"]}
    assert sorted(leaves) == sorted(old)
    for name, w in leaves.items():
        assert torch.equal(w, old[name]), name
        std = 0.02 if name == "embed" else 1 / math.sqrt(w.shape[-2])
        assert abs(w.float().std().item() / std - 1) < 0.05, name
        assert abs(w.float().mean().item()) < 0.05 * std * 10, name
    layer = max(int(np.prod(w.shape[1:])) for n, w in leaves.items() if n != "embed")
    assert max(drawn) == max(layer, 100 * cfg.d_model)
    assert all((params["layers"][n] == 1).all() for n in ("ln1", "ln2"))
