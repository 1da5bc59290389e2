"""Attention on a model axis that its KV heads do not divide, on real gloo
ranks (``parallel.mesh.run_ranks``, the bodies in
``tests/_torch_mesh_ranks.py``).

The smoke granite with 8 q heads and 2 KV heads over a model axis of 4:
each rank takes 2 whole q heads (``w_q``'s columns, ``w_o``'s rows) and
holds ``w_k``/``w_v`` whole (``sharding.attention_split``), its q heads
reading the KV head the reference's GQA grouping gives them. Against one
device:

* serving (``run_oneshot``, forced strassen): float32 tokens equal and
  logits within 1e-4; bf16 within QUALITY_TOL (prefix-matched relative
  logit error, the reference's int8-vs-fp budget): each rank's partial sums
  round where one device rounds once;
* an f32 train step's loss (relative) and every gradient (relative
  Frobenius, gathered whole) within 1e-4 a leaf, and no plan miss after
  ``warm_train``;
* the placement: ``w_q``/``w_o`` split by whole q heads, ``w_k``/``w_v``
  whole, the cache holding both KV heads;
* the same rule under ZeRO-3: 4 q heads over 1 KV head on a 2 x 2 mesh
  with ``fsdp=True``, the whole K/V weights gathered over "data" at use
  and their gradient reduce-scattered back: the f32 loss and gradients
  within 1e-4 of one device.

The dry run of the same rule at production size is in
``tests/test_torch_roofline.py``.
"""
import concurrent.futures
import dataclasses
import types

import jax
import numpy as np
import pytest

import _torch_mesh_ranks as ranks
from repro.configs.registry import smoke_config as j_smoke
from repro.models import model as JM
import repro_torch.api as falcon
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as TM
from repro_torch.parallel import mesh as PM, sharding as SH
from repro_torch.train.steps import loss_and_grads

TIMEOUT = 120
TOL = 1e-4
QUALITY_TOL = 0.15
MODEL = 4
HEADS = dict(num_heads=8, num_kv_heads=2)
FSDP_HEADS = dict(num_heads=4, num_kv_heads=1)
SERVE = dict(batch=2, prompt_len=8, gen=4, seed=3)
DATA = dict(seq_len=16, global_batch=4, seed=3)
OPT = dict(lr=1e-3, grad_clip=0.5)


def _cfg(dtype="float32", heads=HEADS, **kw):
    return dataclasses.replace(smoke_config("granite_3_2b"), dtype=dtype, **heads, **kw)


def _one_device(heads):
    """The reference's weights for ``heads``, the port's f32 config, the
    data and one device's loss and gradients."""
    jcfg = dataclasses.replace(j_smoke("granite_3_2b"), **heads)
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = _cfg(heads=heads)
    data_kw = dict(vocab_size=cfg.vocab_size, **DATA)
    batch = SyntheticLMData(DataConfig(**data_kw), device="cpu").batch(0)
    params = params_from_numpy(np_params, cfg, device="cpu")
    with falcon.use(TM.falcon_config_for(cfg)):
        loss, _, grads = loss_and_grads(params, cfg, batch)
    return np_params, cfg, data_kw, float(loss), ranks._np(grads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One device's runs, then two spawns at once: 4 model ranks running
    the serving and training jobs, and a 2 x 2 ZeRO-3 mesh training."""
    np_params, cfg, data_kw, loss, grads = _one_device(HEADS)
    f_np, f_cfg, f_data, f_loss, f_grads = _one_device(FSDP_HEADS)
    serve = {dt: _cfg(dt, falcon_mode="strassen") for dt in ("float32", "bfloat16")}
    one = {dt: run_oneshot(c, device="cpu", **SERVE) for dt, c in serve.items()}
    jobs = [(dt, "oneshot_run", (c, SERVE)) for dt, c in serve.items()]
    jobs.append(("train", "train_mesh_run", (cfg, np_params, data_kw, 1, OPT, "auto")))
    fsdp_job = [("train", "train_mesh_run", (dataclasses.replace(f_cfg, fsdp=True), f_np,
                                             f_data, 1, OPT, "auto"))]
    work = str(tmp_path_factory.mktemp("qheads"))
    spawns = (({"data": 1, "model": MODEL}, jobs), ({"data": 2, "model": 2}, fsdp_job))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        out, fsdp = pool.map(lambda a: PM.run_ranks(ranks.suite, a[0], a[1], device="cpu",
                                                    workdir=work, timeout=TIMEOUT), spawns)
    return dict(cfg=cfg, one=one, loss=loss, grads=grads, ranks=out,
                fsdp=dict(cfg=f_cfg, loss=f_loss, grads=f_grads, ranks=fsdp))


def test_attention_splits_the_q_heads_and_holds_kv_whole():
    cfg = _cfg()
    assert SH.attention_split(cfg.num_heads, cfg.num_kv_heads, MODEL) == (MODEL, 1)
    params = TM.init_params(cfg, 0, "cpu")
    mesh = {"data": 1, "model": MODEL}
    place = SH.param_sharding(params, mesh, SH.make_rules(mesh), cfg)["layers"]["attn"]
    assert place == {"w_q": ((2, "model"),), "w_k": (), "w_v": (), "w_o": ((1, "model"),)}
    hd = cfg.resolved_head_dim

    class Rank:
        axis_names = ("data", "model")

        def local_rank(self, axis):
            return self.r

    d = cfg.d_model
    for r in range(MODEL):
        rank = Rank()
        rank.r, rank.shape = r, mesh
        local = SH.shard_params(params, cfg, rank)["layers"]["attn"]
        q0 = r * cfg.num_heads // MODEL * hd            # this rank's first q column
        n = cfg.num_heads // MODEL * hd                 # two whole heads
        assert local["w_q"].shape == (cfg.num_layers, d, n)
        assert (local["w_q"] == params["layers"]["attn"]["w_q"][..., q0:q0 + n]).all()
        assert (local["w_o"] == params["layers"]["attn"]["w_o"][:, q0:q0 + n]).all()
        assert local["w_k"] is params["layers"]["attn"]["w_k"]   # whole, not copied
        assert local["w_v"] is params["layers"]["attn"]["w_v"]


def test_q_heads_read_their_kv_heads(world):
    """Rank r's q heads 2r, 2r+1 read KV head (2r + j) * 2 // 8 = r // 2: the
    train job's local shapes and every rank's cache width say so."""
    cfg = world["cfg"]
    hd = cfg.resolved_head_dim
    for r in world["ranks"]:
        shapes = r["train"]["local_shapes"]
        assert shapes["w_q"] == (cfg.num_layers, cfg.d_model, 2 * hd)
        assert shapes["w_k"] == shapes["w_v"] == (cfg.num_layers, cfg.d_model, 2 * hd)
        assert shapes["w_o"] == (cfg.num_layers, 2 * hd, cfg.d_model)
    model_axis = types.SimpleNamespace(size=lambda axis: MODEL)
    with PM.use_mesh(model_axis):               # the cache holds both KV heads
        assert TM.init_cache(cfg, 1, 4, device="cpu")["k"].shape[-2] == cfg.num_kv_heads


def test_f32_serving_matches_one_device(world):
    one = world["one"]["float32"]
    for r in world["ranks"]:
        got = r["float32"]
        np.testing.assert_array_equal(got["tokens"], one["tokens"].numpy())
        worst = max(float(np.max(np.abs(a - b.numpy())))
                    for a, b in zip(got["logits"], one["logits"]))
        assert worst < TOL, worst
        calls = got["mesh"]["collective_calls"]
        assert calls["all_reduce"] > 0 and calls["all_gather"] > 0


def test_bf16_serving_within_quality_tol_of_one_device(world):
    one = world["one"]["bfloat16"]
    want_tok = one["tokens"].numpy()
    want = [lg.float().numpy() for lg in one["logits"]]
    for r in world["ranks"]:
        tok, got = r["bfloat16"]["tokens"], r["bfloat16"]["logits"]
        worst, compared = 0.0, 0
        for b in range(want_tok.shape[0]):
            scale = max(float(np.abs(w[b]).max()) for w in want)
            for t in range(want_tok.shape[1]):
                if (tok[b, :t] != want_tok[b, :t]).any():
                    break
                worst = max(worst, float(np.abs(got[t][b] - want[t][b]).max()) / scale)
                compared += 1
        assert compared >= want_tok.shape[0]
        assert worst <= QUALITY_TOL, worst


def _check_train(got_ranks, want_loss, want_grads):
    for r in got_ranks:
        t = r["train"]
        assert abs(t["loss"] - want_loss) / abs(want_loss) < TOL
        got, want = _flat(t["grads"]), _flat(want_grads)
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k], want[k]) < TOL, k
        assert t["misses_after_warm"] == 0
        # the whole K/V weights' gradients are summed over the model axis
        assert t["stats"]["collective_calls"]["all_reduce/bwd"] > 0


def test_train_step_matches_one_device(world):
    _check_train(world["ranks"], world["loss"], world["grads"])


def test_fsdp_train_step_with_whole_kv_matches_one_device(world):
    """2 x 2, ZeRO-3 over "data": ``w_k``/``w_v`` are split over "data"
    only, gathered at use and reduce-scattered back."""
    f = world["fsdp"]
    cfg = dataclasses.replace(f["cfg"], fsdp=True)
    assert SH.attention_split(cfg.num_heads, cfg.num_kv_heads, 2) == (2, 1)
    params = TM.init_params(cfg, 0, "cpu")
    mesh = {"data": 2, "model": 2}
    place = SH.param_sharding(params, mesh, SH.make_rules(mesh, fsdp=True), cfg)
    attn = place["layers"]["attn"]
    assert attn["w_k"] == attn["w_v"] == ((1, "data"),)
    assert attn["w_q"] == ((1, "data"), (2, "model")) and attn["w_o"] == ((1, "model"), (2, "data"))
    _check_train(f["ranks"], f["loss"], f["grads"])
    for r in f["ranks"]:
        calls = r["train"]["stats"]["collective_calls"]
        assert calls["all_gather"] > 0 and calls["reduce_scatter/bwd"] > 0
