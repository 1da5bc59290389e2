"""The reference's deprecated per-call ``fcfg=`` forms and ``core/``
re-exports, in the port.

* Every function the reference gives an ``fcfg`` keyword (``forward``,
  ``compute_logits``, ``chunked_xent``, ``lm_loss``, ``attn_apply``,
  ``mlp_apply``, ``moe_apply``, ``ssd_apply`` and the ``make_*_step``
  factories) takes it in the port, warns exactly one DeprecationWarning,
  and returns what the same call under ``with falcon.use(cfg):`` returns,
  bit for bit; the override is really installed (forced strassen reaches
  the fused kernels' plain versions).
* ``engine.config_scope(fcfg, where, default_factory)``, the reference's
  signature: override, then ambient, then default.
* The port's own paths run clean under ``-W error::DeprecationWarning``
  (the reference's ``tests/test_api.py`` lane).
* ``repro_torch.core.__all__`` names what ``repro.core.__all__`` names.
"""
import copy
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.api as falcon
import repro_torch.core as tcore
from repro_torch.configs import smoke_config
from repro_torch.core import engine
from repro_torch.kernels import ops
from repro_torch.models import layers as L, model as M, moe as MOE, ssd as SSD
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import mesh as PM
from repro_torch.train import steps as ST

B, S = 2, 8
FORCED = falcon.FalconConfig(mode="strassen")


def _inputs(arch="granite_3_2b"):
    cfg = smoke_config(arch)
    params = M.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return cfg, params, toks, x


def _attn(fcfg=None):
    cfg, params, _, x = _inputs()
    lp = M.layer_params(params["layers"], 0)
    dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    pos = torch.arange(S).expand(B, S)
    return L.attn_apply(lp["attn"], x, dims, pos, cfg.rope_theta, 0, fcfg)[0]


def _mlp(fcfg=None):
    _, params, _, x = _inputs()
    return L.mlp_apply(M.layer_params(params["layers"], 0)["mlp"], x, fcfg)


def _moe(fcfg=None):
    cfg, params, _, x = _inputs("dbrx_132b")
    return MOE.moe_apply(M.layer_params(params["layers"], 0)["moe"], x, cfg.experts_per_token,
                         cfg.capacity_factor, fcfg)


def _ssd(fcfg=None):
    cfg, params, _, x = _inputs("mamba2_370m")
    return SSD.ssd_apply(M.layer_params(params["layers"], 0)["ssm"], x, cfg, fcfg)


def _forward(fcfg=None):
    cfg, params, toks, _ = _inputs()
    return M.forward(params, cfg, toks, fcfg=fcfg, logits_mode="all")[0]


def _logits(fcfg=None):
    cfg, params, _, x = _inputs()
    return M.compute_logits(params, cfg, x, fcfg)


def _xent(fcfg=None):
    cfg, params, toks, x = _inputs()
    return M.chunked_xent(params, cfg, x, toks, fcfg)


def _loss(fcfg=None):
    cfg, params, toks, _ = _inputs()
    return M.lm_loss(params, cfg, {"tokens": toks, "labels": toks.roll(-1, 1)}, fcfg)


def _train(fcfg=None):
    cfg, params, toks, _ = _inputs()
    opt = AdamWConfig(lr=1e-3)
    step = ST.make_train_step(cfg, opt, 10, 1, fcfg)
    p, _, m = step(params, adamw_init(params, opt), {"tokens": toks, "labels": toks}, 1)
    return m["loss"], p


def _eval(fcfg=None):
    cfg, params, toks, _ = _inputs()
    return ST.make_eval_step(cfg, fcfg)(params, {"tokens": toks, "labels": toks})


def _prefill(fcfg=None):
    cfg, params, toks, _ = _inputs()
    return ST.make_prefill_step(cfg, S + 1, fcfg)(params, toks)


def _serve_prefill(fcfg=None):
    cfg, params, toks, _ = _inputs()
    return ST.make_serve_prefill_step(cfg, S + 1, fcfg)(params, toks,
                                                        torch.tensor([S - 1, S - 3]))


def _cache_rows():
    cfg, params, toks, _ = _inputs()
    cache = M.init_cache(cfg, B, S + 4, device="cpu")
    with torch.inference_mode(), falcon.use(falcon.FalconConfig(mode="gemm")):
        M.forward(params, cfg, toks, cache=cache, cache_index=0)   # the same cache in both
    return cfg, params, cache


def _chunk(fcfg=None):
    cfg, params, cache = _cache_rows()
    toks = torch.ones((B, 2), dtype=torch.long)
    return ST.make_chunk_prefill_step(cfg, fcfg)(params, cache, toks, torch.tensor([S, S]),
                                                 torch.tensor([1, 0]))


def _decode(fcfg=None):
    cfg, params, cache = _cache_rows()
    return ST.make_decode_step(cfg, fcfg)(params, cache, torch.ones((B, 1), dtype=torch.long),
                                          torch.tensor([S, S]))


def _verify(fcfg=None):
    cfg, params, cache = _cache_rows()
    return ST.make_verify_step(cfg, fcfg)(params, cache, torch.ones((B, 3), dtype=torch.long),
                                          torch.tensor([S, S - 1]))


FORMS = {"attn_apply": _attn, "mlp_apply": _mlp, "moe_apply": _moe, "ssd_apply": _ssd,
         "forward": _forward, "compute_logits": _logits, "chunked_xent": _xent,
         "lm_loss": _loss, "make_train_step": _train, "make_eval_step": _eval,
         "make_prefill_step": _prefill, "make_serve_prefill_step": _serve_prefill,
         "make_chunk_prefill_step": _chunk, "make_decode_step": _decode,
         "make_verify_step": _verify}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.detach()]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


@pytest.fixture()
def fused_calls(monkeypatch):
    """Counts the LCMA pipelines' calls of the fused kernels (#3, #4)."""
    n = [0]
    for name in ("fused_gemm_combine_h", "batched_fused_gemm_combine_h"):
        def counted(*a, _orig=getattr(ops, name), **kw):
            n[0] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return n


@pytest.mark.parametrize("name", list(FORMS))
def test_fcfg_warns_once_and_equals_use(name, fused_calls):
    form = FORMS[name]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = form(FORCED)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "falcon.use" in str(dep[0].message), [str(w.message) for w in dep]
    assert fused_calls[0] > 0                      # the override reached the LCMA path
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with falcon.use(FORCED):
            want = form()
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


def test_compressed_dp_fcfg_warns_once_and_equals_use(tmp_path):
    out = PM.run_ranks(_compressed_rank, {"data": 1, "model": 1}, device="cpu",
                       workdir=str(tmp_path), timeout=120)
    warned, got, want = out[0]
    assert warned == 1
    assert len(got) == len(want) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))


def _compressed_rank(mesh):
    cfg, params, toks, _ = _inputs()
    opt = AdamWConfig(lr=1e-3)
    batch = {"tokens": toks, "labels": toks}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = ST.make_compressed_dp_train_step(cfg, opt, mesh, 8, FORCED, 10, 1)
    warned = sum(issubclass(w.category, DeprecationWarning) for w in caught)
    p1 = copy.deepcopy(params)
    got = step(p1, adamw_init(p1, opt), batch, 1)
    plain = ST.make_compressed_dp_train_step(cfg, opt, mesh, 8, None, 10, 1)
    with falcon.use(FORCED):
        want = plain(params, adamw_init(params, opt), batch, 1)
    return warned, [t.numpy() for t in _leaves(got)], [t.numpy() for t in _leaves(want)]


def test_config_scope_resolves_override_ambient_default():
    """The reference's ``config_scope(fcfg, where, default_factory)``: the
    deprecated override (warned, naming ``where``) over the ambient config
    over the default; ``fcfg=None`` warns nothing."""
    default = falcon.FalconConfig(mode="gemm")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with engine.config_scope(None, "x", lambda: default):
            assert engine.current_config() is default
        with falcon.use(FORCED), engine.config_scope(None, "x", lambda: default):
            assert engine.current_config() is FORCED     # the ambient one over the default
    with pytest.warns(DeprecationWarning, match="where_it_was"):
        with falcon.use(default), engine.config_scope(FORCED, "where_it_was", lambda: default):
            assert engine.current_config() is FORCED     # the override over the ambient one


def test_ported_paths_are_warning_free():
    """The port's own model, train and serve paths pass no ``fcfg``."""
    cfg, params, toks, _ = _inputs()
    cfg = dataclasses.replace(cfg, remat=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with falcon.use(M.falcon_config_for(cfg)):
            M.forward(params, cfg, toks)
            loss, _ = M.lm_loss(params, cfg, {"tokens": toks, "labels": toks})
            opt = AdamWConfig(lr=1e-3)
            ST.make_train_step(cfg, opt, 10, 1)(params, adamw_init(params, opt),
                                                {"tokens": toks, "labels": toks}, 1)
        ST.make_prefill_step(cfg, S + 1)(params, toks)
        from repro_torch.launch.serve import run_oneshot
        run_oneshot(smoke_config("granite_3_2b"), device="cpu", batch=1, prompt_len=4, gen=2)
    assert torch.isfinite(loss)


def test_core_all_matches_reference():
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
