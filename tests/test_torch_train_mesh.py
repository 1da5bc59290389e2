"""Multi-device training of the port on real gloo ranks, against one device
and the reference.

Three spawns (``parallel.mesh.run_ranks``, one per mesh shape, the last two
at once; each rank runs a list of bodies of ``tests/_torch_mesh_ranks.py``)
train the smoke
granite in float32 on the reference's weights (``params_from_numpy``):

* ``lm_loss`` and every gradient on 2 x 1 FSDP (ZeRO-3 over "data"), 1 x 2
  tensor parallel, 2 x 2 TP + FSDP and 2 x 2 ``fsdp_only`` match one
  device within 1e-5 (relative; the gradients gathered whole, relative
  Frobenius per leaf), and one device matches the reference's ``lm_loss``
  within 1e-5; ``tp`` and ``fsdp_only`` agree within 1e-4 (the
  reference's ``tests/test_parallel_styles.py`` bar). No rank misses a plan
  after ``warm_train(mesh_shape=)``.
* After 3 AdamW steps with clipping active (``grad_clip`` below every
  step's norm, so the global norm over the shards decides each step) the
  parameters match one device's within 1e-5.
* Each rank's rows of ``SyntheticLMData`` over ("data",) and over ("data",
  "model"), concatenated in rank order, are the reference's batch.
* A checkpoint saved on 2 x 1 FSDP (shards gathered to rank 0) restores
  bit-equal on 1 x 2, on 2 x 2 and on one device; its digest is the
  reference's save of the same tree.
* The smoke dbrx MoE layer on 2 x 2 (experts over "model", tokens over
  "data"): output and gradients match one device within 1e-5.

The launcher's mesh runs are in ``tests/test_torch_train.py``.
Every ``run_ranks`` call times out after ``TIMEOUT`` seconds.
"""
import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.registry import smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig, SyntheticLMData as JData
from repro.models import model as JM, moe as jmoe
import repro_torch.api as falcon
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import model as TM, moe as tmoe
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import mesh as PM
from repro_torch.train.steps import loss_and_grads, make_train_step

TIMEOUT = 120
TOL = 1e-5
STYLES_TOL = 1e-4
STEPS = 3
OPT = dict(lr=1e-3, grad_clip=0.5)
CASES = {"fsdp_2x1": ((2, 1), dict(fsdp=True)),
         "tp_1x2": ((1, 2), dict(fsdp=False)),
         "tp_fsdp_2x2": ((2, 2), dict(fsdp=True)),
         "fsdp_only_2x2": ((2, 2), dict(fsdp=True, parallel_style="fsdp_only"))}
DATA = dict(seq_len=16, global_batch=4, seed=3)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _worst(got, want) -> float:
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    return max(_rel(g[k], w[k]) for k in w)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's weights, the one-device run, and the three spawns."""
    work = tmp_path_factory.mktemp("train_mesh")
    jcfg = j_smoke("granite_3_2b")
    cfg = smoke_config("granite_3_2b")
    assert cfg.dtype == "float32" and not cfg.fsdp
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    data_kw = dict(vocab_size=cfg.vocab_size, **DATA)
    batch = SyntheticLMData(DataConfig(**data_kw), device="cpu").batch(0)
    # one device: lm_loss and its gradients, then STEPS AdamW steps
    params = params_from_numpy(np_params, cfg, device="cpu")
    with falcon.use(TM.falcon_config_for(cfg)):
        loss, _, grads = loss_and_grads(params, cfg, batch)
        opt = AdamWConfig(**OPT)
        state = adamw_init(params, opt)
        step = make_train_step(cfg, opt, total_steps=STEPS + 1, warmup=1)
        norms = []
        for i in range(1, STEPS + 1):
            params, state, m = step(params, state, batch, i)
            norms.append(float(m["grad_norm"]))
    one = {"loss": float(loss), "grads": ranks._np(grads), "params": ranks._np(params),
           "grad_norms": norms}
    jloss, _ = JM.lm_loss(jax.tree.map(jnp.asarray, np_params), jcfg,
                          {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    # the MoE layer's inputs: the reference's smoke dbrx layer
    dcfg = smoke_config("dbrx_132b")
    moe_p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(1), dcfg.d_model,
                                                   dcfg.d_ff, dcfg.num_experts, jnp.float32))
    moe_x = np.random.default_rng(2).standard_normal((8, 16, dcfg.d_model)).astype(np.float32)
    moe_args = (moe_p, moe_x, dcfg.experts_per_token, 256)
    ckpt = str(work / "ckpt")
    jobs = {s: [] for s in ((2, 1), (1, 2), (2, 2))}
    for name, (shape, kw) in CASES.items():
        jobs[shape].append((name, "train_mesh_run", (dataclasses.replace(cfg, **kw), np_params,
                                                     data_kw, STEPS, OPT, "auto")))
    for shape in jobs:
        for spec in (("data",), ("data", "model")):
            jobs[shape].append((f"data{spec}", "data_run", (data_kw, spec, 5)))
    jobs[(2, 1)].append(("save", "checkpoint_save_run", (cfg, np_params, ckpt)))
    for shape in ((1, 2), (2, 2)):
        jobs[shape].append(("restore", "checkpoint_restore_run", (cfg, np_params, ckpt)))
    jobs[(2, 2)].append(("moe", "moe_train_layer_run", moe_args))
    def spawn(shape):
        return PM.run_ranks(ranks.suite, {"data": shape[0], "model": shape[1]}, jobs[shape],
                            device="cpu", workdir=str(work), timeout=TIMEOUT)

    out = {(2, 1): spawn((2, 1))}           # the save, before the restores
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        out.update(zip(((1, 2), (2, 2)), pool.map(spawn, ((1, 2), (2, 2)))))
    return dict(cfg=cfg, jcfg=jcfg, np_params=np_params, data_kw=data_kw, one=one,
                jloss=float(jloss), ranks=out, ckpt=ckpt, moe_args=moe_args, work=work)


def _case(world, name):
    shape = CASES[name][0]
    return [r[name] for r in world["ranks"][shape]]


@pytest.mark.parametrize("name", list(CASES))
def test_lm_loss_and_gradients_match_one_device(world, name):
    one = world["one"]
    for r in _case(world, name):            # every rank holds the same whole values
        assert abs(r["loss"] - one["loss"]) / abs(one["loss"]) < TOL
        assert _worst(r["grads"], one["grads"]) < TOL
        assert r["misses_after_warm"] == 0


def test_one_device_matches_reference_lm_loss(world):
    assert abs(world["one"]["loss"] - world["jloss"]) / abs(world["jloss"]) < TOL


def test_tp_and_fsdp_only_agree(world):
    tp, fo = _case(world, "tp_fsdp_2x2")[0], _case(world, "fsdp_only_2x2")[0]
    assert abs(tp["loss"] - fo["loss"]) / abs(fo["loss"]) < STYLES_TOL
    assert _worst(tp["grads"], fo["grads"]) < STYLES_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_adamw_with_clipping_matches_one_device(world, name):
    one = world["one"]
    assert min(one["grad_norms"]) > OPT["grad_clip"]          # clipping is active
    for r in _case(world, name):
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"], rtol=TOL)
        assert _worst(r["params"], one["params"]) < TOL


def test_placements_and_collectives(world):
    """What each style holds and moves: FSDP gathers weights and
    reduce-scatters their gradients; TP's *f* all-reduces in backward;
    fsdp_only holds no TP shard."""
    shapes = {n: _case(world, n)[0]["local_shapes"] for n in CASES}
    assert shapes["fsdp_2x1"]["w_q"] == (2, 32, 64) and shapes["fsdp_2x1"]["w_o"] == (2, 64, 32)
    assert shapes["tp_1x2"]["w_q"] == (2, 64, 32) and shapes["tp_1x2"]["w_o"] == (2, 32, 64)
    assert shapes["tp_fsdp_2x2"]["w_q"] == (2, 32, 32)
    assert shapes["fsdp_only_2x2"]["w_q"] == (2, 16, 64)
    calls = {n: _case(world, n)[0]["stats"]["collective_calls"] for n in CASES}
    for n in ("fsdp_2x1", "tp_fsdp_2x2", "fsdp_only_2x2"):
        assert calls[n]["all_gather"] > 0 and calls[n]["reduce_scatter/bwd"] > 0
    for n in ("tp_1x2", "tp_fsdp_2x2"):
        assert calls[n]["all_reduce/bwd"] > 0
    assert "all_reduce/bwd" not in calls["fsdp_only_2x2"]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_data_slices_are_the_reference_batch(world, shape):
    want = JData(JDataConfig(**world["data_kw"])).batch(5)
    for spec in (("data",), ("data", "model")):
        rows = [r[f"data{spec}"] for r in world["ranks"][shape]]
        if spec == ("data",):       # the model axis's ranks share their rows
            rows = rows[::shape[1]]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(np.concatenate([r[k] for r in rows]),
                                          np.asarray(want[k], np.int64))


def test_checkpoint_saved_on_fsdp_restores_anywhere(world):
    cfg, np_params, ckpt = world["cfg"], world["np_params"], world["ckpt"]
    assert world["ranks"][(2, 1)][0]["save"]["w_q"] == (2, 32, 64)     # saved from shards
    want = _flat({"params": np_params})
    for shape in ((1, 2), (2, 2)):
        for r in world["ranks"][shape]:
            assert r["restore"]["step"] == 3
            got = _flat(r["restore"]["tree"])
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    assert world["ranks"][(2, 2)][0]["restore"]["local"]["w_q"] == (2, 32, 32)
    like = {"params": params_from_numpy(np_params, cfg, device="cpu")}
    tree, step, _ = restore_checkpoint(ckpt, like, device="cpu")          # one device
    got = _flat(tree)
    assert step == 3 and all(np.array_equal(got[k], want[k]) for k in want)
    ref_dir = str(world["work"] / "ref_ckpt")
    j_save(ref_dir, 3, {"params": jax.tree.map(jnp.asarray, np_params)})
    digest = [json.load(open(os.path.join(d, "step_0000000003", "manifest.json")))["sha256"]
              for d in (ckpt, ref_dir)]
    assert digest[0] == digest[1]


def test_expert_parallel_training_layer_matches_one_device(world):
    p_np, x, top_k, cap = world["moe_args"]
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p_np.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with falcon.use(falcon.FalconConfig(mode="gemm")):
        y, _ = tmoe.moe_apply(p, xt, top_k, 1.25, deterministic_capacity=cap)
        gs = torch.autograd.grad(torch.sum(y ** 2), [xt, *(p[k] for k in sorted(p))])
    out = world["ranks"][(2, 2)]
    got_y = np.concatenate([r["moe"]["y"] for r in out[::2]])        # the data ranks
    got_dx = np.concatenate([r["moe"]["dx"] for r in out[::2]])
    assert _rel(got_y, y.detach().numpy()) < TOL and _rel(got_dx, gs[0].numpy()) < TOL
    want = {k: g.numpy() for k, g in zip(sorted(p), gs[1:])}
    for r in out:
        assert r["moe"]["held"] == p["router"].shape[-1] // 2          # experts over model
        assert _worst(r["moe"]["grads"], want) < TOL
