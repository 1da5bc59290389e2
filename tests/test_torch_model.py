"""The port's decoder and one-shot serving against the reference, on the CPU.

``lcma_smoke_config("granite_3_2b")`` (2 layers, d_model 256) with the same
weights in both packages: the reference's ``init_params`` tree goes through
``convert.params_from_numpy``. The reference runs its Pallas kernels in
interpret mode; the port runs its kernels' plain versions. Prefill logits
and four decode steps agree at rtol/atol 1e-4 in f32 — the two compute the
same scheme with matmul sums in a different order — and greedy tokens and
the number of precombined weights are equal. Forced strassen, auto mode
(on one profile given to both) and plain GEMM are checked alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.configs.registry import lcma_smoke_config as j_smoke
from repro.core import hardware as jhw
from repro.models import layers as JL, model as JM
from repro.train.steps import make_decode_step, make_prefill_step
import repro_torch.api as tfalcon
from repro_torch.configs import lcma_smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import hardware as thw
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import layers as TL, model as TM

B, S, GEN = 2, 16, 5            # prefill + 4 decode steps
# a profile under which LCMAs win at smoke shapes, given to both packages
PROFILE = dict(name="model_parity_profile", flops_mul=2e12, flops_add=5e13,
               beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
               mxu_align=8, dtype_flops=None, lcma_gemm_efficiency=1.0)
# auto mode chooses among a few small-rank schemes (the interpret-mode
# reference is slow on high-rank ones)
AUTO_CANDIDATES = ("strassen", "strassen-winograd", "s223")
TOL = dict(rtol=1e-4, atol=1e-4)


def _reference(mode: str):
    """Reference run: (params as numpy, last-position logits per step,
    greedy tokens, n_precombined). Prompts come from ``default_rng(0)``, as
    in ``run_oneshot(seed=0)``."""
    cfg = dataclasses.replace(j_smoke("granite_3_2b"), falcon_mode=mode,
                              falcon_backend="pallas_interpret")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    fcfg = JM.falcon_config_for(cfg)
    if mode == "auto":
        jhw.register_profile(jhw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES)
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


@pytest.fixture(scope="module", params=["strassen", "auto", "gemm"])
def pair(request):
    mode = request.param
    np_params, logits, tokens, n_pre = _reference(mode)
    cfg = dataclasses.replace(t_smoke("granite_3_2b"), falcon_mode=mode)
    params = params_from_numpy(np_params, cfg, device="cpu")
    fcfg = TM.falcon_config_for(cfg)
    if mode == "auto":
        thw.register_profile(thw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES)
    with tfalcon.use(fcfg):
        res = run_oneshot(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device="cpu",
                          params=params)
    return mode, (logits, tokens, n_pre), res


def test_logits_match_reference(pair):
    mode, (logits, _, _), res = pair
    assert len(res["logits"]) == len(logits) == GEN
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{mode} step {step}",
                                   **TOL)


def test_greedy_tokens_and_precombine_match_reference(pair):
    mode, (_, tokens, n_pre), res = pair
    np.testing.assert_array_equal(res["tokens"].numpy(), tokens)
    assert res["n_precombined"] == n_pre
    if mode == "auto":
        assert n_pre > 0       # the profile makes LCMAs win at the prefill M
    else:
        assert n_pre == {"gemm": 0, "strassen": 7}[mode]


def test_forward_cache_paths_agree():
    """Prefill with a cache, then one decode step, equals the full forward
    over the longer sequence (the in-place KV writes and validity mask)."""
    cfg = dataclasses.replace(t_smoke("granite_3_2b"), falcon_mode="strassen")
    params = TM.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)))
    full, _ = TM.forward(params, cfg, toks, logits_mode="all")
    cache = TM.init_cache(cfg, B, S + 4, device="cpu")
    TM.forward(params, cfg, toks[:, :S], cache=cache, cache_index=0)
    last, _ = TM.forward(params, cfg, toks[:, S:], cache=cache, cache_index=S,
                         logits_mode="last")
    torch.testing.assert_close(last[:, 0], full[:, S], rtol=1e-4, atol=1e-4)
    assert (full[..., cfg.vocab_size:] == -1e30).all()


def _layer_inputs(rng):
    d, H, Hkv, hd = 64, 4, 2, 16
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in [("w_q", (d, H * hd)), ("w_k", (d, Hkv * hd)),
                      ("w_v", (d, Hkv * hd)), ("w_o", (H * hd, d))]}
    x = rng.standard_normal((B, 3, d)).astype(np.float32)
    cache = {n: rng.standard_normal((B, 8, Hkv, hd)).astype(np.float32)
             for n in ("k", "v")}
    return p, x, cache, (d, H, Hkv, hd)


@pytest.mark.parametrize("index", ["none", "scalar", "vector"])
@pytest.mark.parametrize("window", [0, 2])
def test_attn_apply_matches_reference(index, window, rng):
    p, x, cache, dims = _layer_inputs(rng)
    cache_index = {"none": None, "scalar": 4, "vector": np.array([2, 5])}[index]
    positions = np.arange(3)[None] + (0 if cache_index is None else
                                      np.broadcast_to(cache_index, (B,))[:, None])
    jd, td = JL.AttnDims(*dims), TL.AttnDims(*dims)
    jcache = None if index == "none" else {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = None if index == "none" else {k: torch.tensor(v) for k, v in cache.items()}
    want, jnew = JL.attn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                               jd, jnp.asarray(positions), 1e4, window, cache=jcache,
                               cache_index=None if cache_index is None else
                               jnp.asarray(cache_index))
    got, tnew = TL.attn_apply({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                              td, torch.as_tensor(positions), 1e4, window, cache=tcache,
                              cache_index=None if cache_index is None else
                              (torch.as_tensor(cache_index) if index == "vector"
                               else cache_index))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if index != "none":
        for k in ("k", "v"):
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                       rtol=1e-6, atol=1e-6)


def test_norm_rope_mlp_match_reference(rng):
    x = rng.standard_normal((B, 5, 4, 16)).astype(np.float32)
    pos = np.arange(5)[None].repeat(B, 0) + 3
    np.testing.assert_allclose(
        TL.rope(torch.tensor(x), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((B, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(torch.tensor(h), torch.tensor(s)).numpy(),
                               np.asarray(JL.rmsnorm(jnp.asarray(h), jnp.asarray(s))),
                               rtol=1e-5, atol=1e-5)
    p = {n: (rng.standard_normal(sh) / 8).astype(np.float32) for n, sh in
         [("mlp_gate", (64, 128)), ("mlp_up", (64, 128)), ("mlp_down", (128, 64))]}
    np.testing.assert_allclose(
        TL.mlp_apply({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(h)).numpy(),
        np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


def test_layer_without_mlp_matches_reference():
    """A smoke granite with ``d_ff = 0``: no MLP params in either package,
    each layer adds zeros in place of the MLP; prefill logits and the
    lm_loss agree with the reference's (f32, the reference's weights) at
    1e-5, prefill + one decode step through the cache too."""
    from repro.configs.registry import smoke_config as js
    from repro_torch.configs import smoke_config as ts
    jcfg = dataclasses.replace(js("granite_3_2b"), d_ff=0, falcon_backend="jnp")
    tcfg = dataclasses.replace(ts("granite_3_2b"), d_ff=0)
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = TM.init_params(tcfg, 0, "cpu")
    assert "mlp" not in np_params["layers"] and "mlp" not in tparams["layers"]
    params = params_from_numpy(np_params, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    with jfalcon.use(JM.falcon_config_for(jcfg)):
        jp = jax.tree.map(jnp.asarray, np_params)
        want, jcache = make_prefill_step(jcfg, max_len=S + 1)(jp, jnp.asarray(prompt))
        nxt = jnp.argmax(want[:, -1], -1)[:, None]
        want2, _ = make_decode_step(jcfg)(jp, jcache, nxt, S)
        jloss, _ = JM.lm_loss(jp, jcfg, {"tokens": jnp.asarray(prompt),
                                        "labels": jnp.asarray(np.roll(prompt, -1, 1))})
    with torch.no_grad():
        cache = TM.init_cache(tcfg, B, S + 1, device="cpu")
        got, cache = TM.forward(params, tcfg, torch.from_numpy(prompt), cache=cache,
                                cache_index=0, logits_mode="last")
        got2, _ = TM.forward(params, tcfg, torch.tensor(np.asarray(nxt)), cache=cache,
                             cache_index=S, logits_mode="last")
        tloss, _ = TM.lm_loss(params, tcfg, {"tokens": torch.from_numpy(prompt),
                                             "labels": torch.from_numpy(np.roll(prompt, -1, 1))})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5, atol=1e-5)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
