"""The port's training path against the reference's, on the CPU.

The same weights (the reference's ``init_params`` carried across by
``convert.params_from_numpy``) and the same numpy batches go through both
packages in float32; the port's kernels run their plain versions.

* ``lm_loss`` (and its gradients) for the dense, MoE (load-balancing loss
  included), audio, vlm and SSM smoke configs; the SSD scan's gradients
  (its chunk carry without ``out=``); the tied LM head's two gradient
  shares; the stacked leaves unbound once under autograd; remat on and off.
* ``make_train_step``: a 3-step forced-strassen trajectory against the
  reference's jitted one at its own tolerance (rtol 5e-3 / atol 5e-4);
  ``microbatches=2`` against the whole batch.
* AdamW, clipping and the cosine schedule (``tests/test_optim.py``), and
  one update against the reference's on the same numbers, f32 and bf16.
* ``SyntheticLMData`` bit-equal to the reference's; ``TrainLoop`` faults,
  retries, preemption and stragglers (``tests/test_train_loop.py``); a
  checkpoint the reference's loop wrote resumed by the port's loop.
* ``launch.train --device cpu``; ``tune --train`` probing and warming the
  backward triples.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig, SyntheticLMData as JData
from repro.models import model as JM, ssd as JSSD
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_init as j_adamw_init,
                         adamw_update as j_adamw_update, cosine_schedule as j_cosine)
from repro.train import TrainLoop as JTrainLoop, TrainLoopConfig as JLoopConfig
from repro.train.steps import make_train_step as j_make_train_step
import repro_torch.api as tfalcon
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.core import hardware as thw, plan_cache as tpc
from repro_torch.core.falcon_gemm import FalconConfig as TConfig
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import model as TM, ssd as TSSD
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train import FaultInjector, TrainLoop, TrainLoopConfig, make_train_step
from repro_torch.train.steps import loss_and_grads, make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAJ_TOL = dict(rtol=5e-3, atol=5e-4)       # tests/test_grads.py's trajectory tolerance
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
B, S = 2, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch: str, mode: str = "gemm", **replace):
    """(reference cfg, port cfg, reference params, port params) on the same
    weights, smoke size, f32."""
    jcfg = dataclasses.replace(jreg.smoke_config(arch), falcon_mode=mode, **replace)
    tcfg = dataclasses.replace(treg.smoke_config(arch), falcon_mode=mode, **replace)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(_np_tree(jp), tcfg, device="cpu")


def _batch(cfg, seed: int = 1, patches: bool = True):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.frontend == "audio_codebooks" else (B, S)
    toks = rng.integers(0, cfg.vocab_size, shape)
    np_batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend == "vision_patches" and patches:
        np_batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.float32 if k == "patch_embeds" else jnp.int32)
          for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return jb, tb


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (numpy or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


LOSS_CASES = [("granite_3_2b", "gemm"), ("granite_3_2b", "strassen"),
              ("dbrx_132b", "gemm"), ("dbrx_132b", "strassen"), ("musicgen_large", "gemm"),
              ("pixtral_12b", "gemm"), ("mamba2_370m", "strassen"), ("hymba_1_5b", "gemm")]


@pytest.mark.parametrize("arch,mode", LOSS_CASES)
def test_lm_loss_and_grads_match_reference(arch, mode):
    """The loss, its parts and every leaf's gradient: dense, MoE (aux in
    the loss), audio (labels (B, S, CB)), vlm (text positions only), SSM
    and hybrid."""
    jcfg, tcfg, jp, tp = _pair(arch, mode)
    jb, tb = _batch(tcfg)
    (jloss, jm), jg = jax.value_and_grad(lambda p: JM.lm_loss(p, jcfg, jb), has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tp, tcfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **LOSS_TOL)
    if tcfg.family == "moe":
        assert float(metrics["aux"]) > 0
        np.testing.assert_allclose(float(loss), float(metrics["xent"] + 0.01 * metrics["aux"]),
                                   rtol=1e-6)
    want, got = _flat(_np_tree(jg)), _flat(grads)
    assert want.keys() == got.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * scale * 100, err_msg=k)
        assert float(got[k].abs().max()) > 0 or float(np.abs(want[k]).max()) == 0, k


def test_eval_step_equals_lm_loss():
    _, tcfg, _, tp = _pair("dbrx_132b")
    _, tb = _batch(tcfg)
    got = make_eval_step(tcfg)(tp, tb)
    with torch.no_grad():
        loss, m = TM.lm_loss(tp, tcfg, tb)
    assert float(got["loss"]) == float(loss) and float(got["aux"]) == float(m["aux"])
    assert not got["loss"].requires_grad


@pytest.mark.parametrize("mode", ["gemm", "strassen"])
def test_ssd_scan_grads_match_reference(mode, rng):
    """The chunk carry runs without ``out=`` so autograd follows it: the
    scan's gradients (ragged tail, an initial state) equal the reference's."""
    Bb, L, H, P, G, N, chunk = 2, 21, 4, 8, 1, 16, 8
    arrays = [rng.standard_normal((Bb, L, H, P)), np.abs(rng.standard_normal((Bb, L, H))) * 0.1,
              rng.standard_normal(H) * 0.5, rng.standard_normal((Bb, L, G, N)),
              rng.standard_normal((Bb, L, G, N)), rng.standard_normal((Bb, H, N, P))]
    weights = [rng.standard_normal((Bb, L, H, P)), rng.standard_normal((Bb, H, N, P))]
    tcfg, jcfg = TConfig(mode=mode), dataclasses.replace(
        JM.falcon_config_for(jreg.smoke_config("mamba2_370m")), mode=mode, backend="jnp")

    def jloss(x, dt, A, B_, C_, s0):
        import repro.api as jfalcon
        with jfalcon.use(jcfg):
            y, fin = JSSD.ssd_scan(x, dt, A, B_, C_, chunk, init_state=s0)
        return jnp.sum(y * weights[0]) + jnp.sum(fin * weights[1])

    want = jax.grad(jloss, tuple(range(6)))(*[jnp.asarray(a, jnp.float32) for a in arrays])
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in arrays]
    with tfalcon.use(tcfg):
        y, fin = TSSD.ssd_scan(*ts[:5], chunk, init_state=ts[5])
    loss = (y * torch.from_numpy(weights[0]).float()).sum() + \
        (fin * torch.from_numpy(weights[1]).float()).sum()
    got = torch.autograd.grad(loss, ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3)


def test_tied_head_gets_both_gradient_shares():
    """The tied head's ``embed.T`` reaches the planned core as a view: its
    dB comes back through the view, and the lookup adds its own share."""
    _, tcfg, _, tp = _pair("granite_3_2b", "strassen")
    _, tb = _batch(tcfg)
    _, _, grads = loss_and_grads(tp, tcfg, tb)
    rows = torch.zeros(tcfg.vocab_size, dtype=torch.bool)
    rows[tb["tokens"].flatten()] = True
    g = grads["embed"][:tcfg.vocab_size]
    # every row gets the head's share; only looked-up rows get the lookup's
    head_only = g[~rows]
    assert float(head_only.abs().min(dim=-1).values.min()) > 0
    with torch.no_grad():
        hidden, _ = TM.forward(tp, tcfg, tb["tokens"])
    emb = tp["embed"].detach().clone().requires_grad_()
    head = dict(tp, embed=emb)
    lookup_free = TM.chunked_xent(head, tcfg, hidden, tb["labels"])
    (g_head,) = torch.autograd.grad(lookup_free, [emb])
    torch.testing.assert_close(g[~rows], g_head[:tcfg.vocab_size][~rows], rtol=1e-4, atol=1e-7)
    assert float((g[rows] - g_head[:tcfg.vocab_size][rows]).abs().max()) > 0


def _leaf_users(t: torch.Tensor) -> dict[int, list[str]]:
    """For each leaf tensor in ``t``'s autograd graph (by id), the node
    types that feed its gradient accumulator."""
    seen, stack, users = set(), [t.grad_fn], {}
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        for m, _ in n.next_functions:
            if m is not None and hasattr(m, "variable"):
                users.setdefault(id(m.variable), []).append(type(n).__name__)
            stack.append(m)
    return users


def test_layer_leaves_unbound_once_under_grad():
    """Under autograd each stacked leaf is unbound once (one gradient stack),
    never sliced per layer (a stack-sized zero tensor per slice)."""
    _, tcfg, _, tp = _pair("granite_3_2b", remat=False, num_layers=3)
    _, tb = _batch(tcfg)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(tp, tcfg, tb)
    users = _leaf_users(loss)
    for name, leaf in _flat(tp["layers"]).items():
        assert users[id(leaf)] == ["UnbindBackward0"], name
    assert len(tp["layers"]["ln1"]) == 3


def test_remat_on_and_off_give_equal_grads():
    _, tcfg, _, tp = _pair("dbrx_132b", "strassen")
    _, tb = _batch(tcfg)
    l0, _, g0 = loss_and_grads(tp, dataclasses.replace(tcfg, remat=False), tb)
    # the recomputation runs in backward, outside this scope: it must keep it
    with tfalcon.use(TConfig(mode="strassen")):
        l1, _, g1 = loss_and_grads(tp, dataclasses.replace(tcfg, remat=True), tb)
    assert float(l0) == float(l1)
    for k, v in _flat(g0).items():
        assert torch.equal(_flat(g1)[k], v), k
    # "dots" keeps the 2-D products' outputs and recomputes the rest: the
    # same arithmetic, so the same numbers
    with tfalcon.use(TConfig(mode="strassen")):
        l2, _, g2 = loss_and_grads(tp, dataclasses.replace(tcfg, remat=True,
                                                           remat_policy="dots"), tb)
    assert float(l0) == float(l2)
    for k, v in _flat(g0).items():
        assert torch.equal(_flat(g2)[k], v), k
    with pytest.raises(ValueError, match="remat policy"):
        loss_and_grads(tp, dataclasses.replace(tcfg, remat=True, remat_policy="offload"), tb)


def test_train_step_trajectory_matches_reference():
    """3 steps of the full train step (forward + planned backward + AdamW),
    forced strassen, f32, against the reference's jitted step."""
    jcfg, tcfg, jp, tp = _pair("granite_3_2b", "strassen")
    jb, tb = _batch(tcfg)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=1e-3), warmup=1))
    jo, want = j_adamw_init(jp, JAdamWConfig(lr=1e-3)), []
    tstep = make_train_step(tcfg, AdamWConfig(lr=1e-3), warmup=1)
    to, got = adamw_init(tp, AdamWConfig(lr=1e-3)), []
    for i in range(3):
        jp, jo, m = jstep(jp, jo, jb, jnp.asarray(i))
        want.append(float(m["loss"]))
        tp, to, tm = tstep(tp, to, tb, i)
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, **TRAJ_TOL)
    assert got[-1] < got[0]


def test_microbatches_equal_the_whole_batch():
    _, tcfg, _, tp = _pair("granite_3_2b")
    tcfg = dataclasses.replace(tcfg, remat=False)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (8, S)))
    batch = {"tokens": toks, "labels": toks}
    oc = AdamWConfig(lr=1e-3)
    p1 = tree_map(torch.clone, tp)
    p2 = tree_map(torch.clone, tp)
    p1, _, m1 = make_train_step(tcfg, oc, total_steps=10)(p1, adamw_init(p1, oc), batch, 1)
    p2, _, m2 = make_train_step(tcfg, oc, total_steps=10, microbatches=2)(
        p2, adamw_init(p2, oc), batch, 1)
    p1, p2 = tree_map(torch.Tensor.detach, p1), tree_map(torch.Tensor.detach, p2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 1e-3, d
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, oc, microbatches=3)(p2, adamw_init(p2, oc), batch, 1)


# ---------------------------------------------------------------------------
# Optimizer and schedule (tests/test_optim.py), and against the reference
# ---------------------------------------------------------------------------

def test_adamw_optimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_weight_decay_shrinks_params():
    cfg = AdamWConfig(lr=0.01, weight_decay=0.5)
    params = {"w": torch.ones(4)}
    params, _, _ = adamw_update(params, {"w": torch.zeros(4)}, adamw_init(params, cfg), cfg)
    assert float(params["w"].max()) < 1.0


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 3.7, 10.0])
def test_clip_bounds_norm(max_norm):
    g = {"a": torch.full((16,), 7.0), "b": torch.full((4, 4), -3.0)}
    clipped, gnorm = clip_by_global_norm(g, max_norm)
    total = float(sum((x ** 2).sum() for x in tree_leaves(clipped))) ** 0.5
    assert total <= max_norm * (1 + 1e-5) or total <= float(gnorm) + 1e-5
    jc, jn = __import__("repro.optim", fromlist=["clip_by_global_norm"]).clip_by_global_norm(
        {k: jnp.asarray(v.numpy()) for k, v in g.items()}, max_norm)
    assert float(gnorm) == pytest.approx(float(jn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    assert float(cosine_schedule(0, 10, 100)) == 0.0
    assert abs(float(cosine_schedule(10, 10, 100)) - 1.0) < 1e-5
    assert 0.09 < float(cosine_schedule(100, 10, 100)) < 0.11     # min_ratio floor
    for step in (0, 1, 5, 10, 37, 99, 100, 150):
        assert float(cosine_schedule(step, 10, 100)) == pytest.approx(
            float(j_cosine(step, 10, 100)), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, rng):
    """Two updates on the same numbers: f32 state over ``dtype`` params,
    rounded where the reference rounds; clipping active."""
    p_np = {"a": rng.standard_normal((8, 5)), "b": {"c": rng.standard_normal(3)}}
    g_np = [{"a": rng.standard_normal((8, 5)) * 3, "b": {"c": rng.standard_normal(3)}}
            for _ in range(2)]
    cfg, jcfg = AdamWConfig(lr=1e-2), JAdamWConfig(lr=1e-2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    def to_t(t):
        return _map(lambda x: torch.tensor(np.float32(x)).to(getattr(torch, dtype)), t)

    def to_j(t):
        return _map(lambda x: jnp.asarray(np.float32(x), jdt), t)

    tp, jp = to_t(p_np), to_j(p_np)
    ts, js = adamw_init(tp, cfg), j_adamw_init(jp, jcfg)
    for i, g in enumerate(g_np):
        tp, ts, tm = adamw_update(tp, to_t(g), ts, cfg, lr_scale=cosine_schedule(i + 3, 2, 10))
        jp, js, jm = j_adamw_update(jp, to_j(g), js, jcfg, lr_scale=j_cosine(i + 3, 2, 10))
    assert ts["m"]["a"].dtype == torch.float32 and tp["a"].dtype == getattr(torch, dtype)
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for k, v in _flat(got).items():
            w = np.asarray(_flat(_map(lambda x: np.asarray(x, np.float32), want))[k])
            if dtype == "bfloat16" and got is tp:
                np.testing.assert_allclose(v.float().numpy(), w, rtol=2 ** -7, err_msg=k)
            else:
                np.testing.assert_allclose(v.float().numpy(), w, rtol=1e-5, atol=1e-7, err_msg=k)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


# ---------------------------------------------------------------------------
# Data, the loop, checkpoints across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codebooks", [0, 4])
def test_synthetic_data_bit_equal_to_reference(codebooks):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=3, seed=5, num_codebooks=codebooks)
    t, j = SyntheticLMData(DataConfig(**kw), device="cpu"), JData(JDataConfig(**kw))
    for step in (0, 1, 11):
        tb, jb = t.batch(step), j.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
            assert tb[k].device.type == "cpu"
    b1 = t.batch(11)
    assert not np.array_equal(t.batch(12)["tokens"].numpy(), b1["tokens"].numpy())
    np.testing.assert_array_equal(b1["tokens"][:, 1:].numpy(), b1["labels"][:, :-1].numpy())


@pytest.fixture(scope="module")
def setup():
    cfg = treg.smoke_config("granite_3_2b")
    params = TM.init_params(cfg, 0, "cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                           device="cpu")
    step = make_train_step(cfg, opt_cfg, total_steps=40, warmup=2)

    def fresh():
        p = tree_map(lambda t: t.detach().clone(), params)
        return p, adamw_init(p, opt_cfg)

    step(*fresh(), data.batch(0), 0)     # the first call's one-off costs (plans)
    return fresh, data, step


def test_recovers_from_injected_faults(tmp_path, setup):
    fresh, data, step = setup
    loop = TrainLoop(TrainLoopConfig(total_steps=20, checkpoint_every=5,
                                     checkpoint_dir=str(tmp_path), log_every=100),
                     step, data, *fresh(), fault_injector=FaultInjector({7: 1, 13: 2}))
    out = loop.run()
    assert out["final_step"] == 20 and out["restarts"] == 3
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]      # learning on the Markov synthetic data


def test_aborts_after_max_retries(tmp_path, setup):
    fresh, data, step = setup
    loop = TrainLoop(TrainLoopConfig(total_steps=10, checkpoint_every=100,
                                     checkpoint_dir=str(tmp_path), max_retries_per_step=2,
                                     log_every=100),
                     step, data, *fresh(), fault_injector=FaultInjector({3: 99}))
    with pytest.raises(RuntimeError, match="aborting"):
        loop.run()


def test_preemption_checkpoints_and_resumes(tmp_path, setup):
    fresh, data, step = setup
    loop = TrainLoop(TrainLoopConfig(total_steps=50, checkpoint_every=1000,
                                     checkpoint_dir=str(tmp_path), log_every=100),
                     step, data, *fresh())

    def step_and_preempt(p, o, b, s):
        if s == 6:
            loop.preempt()
        return step(p, o, b, s)

    loop.train_step = step_and_preempt
    out = loop.run()
    assert out["final_step"] < 50
    loop2 = TrainLoop(TrainLoopConfig(total_steps=10, checkpoint_every=1000,
                                      checkpoint_dir=str(tmp_path), log_every=100),
                      step, data, *fresh())
    start = loop2._restore()
    assert start == out["final_step"]
    assert int(loop2.opt_state["step"]) == start
    assert loop2.run(start_step=start)["final_step"] == 10


def test_straggler_detection(tmp_path, setup):
    fresh, data, step = setup
    loop = TrainLoop(TrainLoopConfig(total_steps=12, checkpoint_every=1000,
                                     checkpoint_dir=str(tmp_path), straggler_factor=2.5,
                                     log_every=100),
                     step, data, *fresh())

    took = []

    def slow_step(p, o, b, s):
        t0 = time.perf_counter()
        if s == 8:                     # a slow host: well past factor x EMA, even on a busy CPU
            time.sleep(0.5 + 3 * loop.cfg.straggler_factor * max(took))
        out = step(p, o, b, s)
        took.append(time.perf_counter() - t0)
        return out

    loop.train_step = slow_step
    out = loop.run()
    assert out["stragglers"] >= 1
    assert max(out["history"], key=lambda h: h["time"])["step"] == 8


def test_resumes_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's loop trains 2 steps and checkpoints (params and AdamW
    state, f32), then takes step 2; the port's loop restores that
    checkpoint and takes step 2 to the reference's loss."""
    jcfg = jreg.smoke_config("granite_3_2b")
    tcfg = treg.smoke_config("granite_3_2b")
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    joc = JAdamWConfig(lr=1e-3)
    jloop = JTrainLoop(JLoopConfig(total_steps=3, checkpoint_every=2,
                                   checkpoint_dir=str(tmp_path), log_every=100),
                       jax.jit(j_make_train_step(jcfg, joc, total_steps=40, warmup=2)),
                       JData(JDataConfig(**kw)), jp, j_adamw_init(jp, joc))
    want = jloop.run()["history"][2]["loss"]
    oc = AdamWConfig(lr=1e-3)
    tp = TM.init_params(tcfg, 7, "cpu")          # other weights: the restore replaces them
    loop = TrainLoop(TrainLoopConfig(total_steps=3, checkpoint_every=1000,
                                     checkpoint_dir=str(tmp_path), log_every=100),
                     make_train_step(tcfg, oc, total_steps=40, warmup=2),
                     SyntheticLMData(DataConfig(**kw), device="cpu"), tp, adamw_init(tp, oc))
    start = loop._restore()
    assert start == 2 and int(loop.opt_state["step"]) == 2
    out = loop.run(start_step=start)
    assert out["final_step"] == 3
    np.testing.assert_allclose(out["history"][0]["loss"], want, **TRAJ_TOL)


# ---------------------------------------------------------------------------
# The launcher and the tune CLI
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "granite_3_2b", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--checkpoint-dir", str(tmp_path),
                      "--checkpoint-every", "2"])
    assert out["final_step"] == 3 and len(out["history"]) == 3
    assert "done: 3 steps" in capsys.readouterr().out
    # --compressed-dp on a 2 x 1 mesh of CPU ranks (gloo; the launcher
    # spawns them), and --production-mesh refused on 2 ranks, naming 256
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    env.pop("RANK", None)
    o = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "granite_3_2b", "--device", "cpu", "--mesh", "2,1", "--dist-backend",
                        "gloo", "--compressed-dp", "--steps", "3", "--batch", "4", "--seq",
                        "16", "--checkpoint-dir", str(tmp_path / "mesh")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert o.returncode == 0, o.stderr[-2000:]
    assert o.stdout.count("done: 3 steps") == 1 and "all_reduce_max" in o.stdout
    with pytest.raises(ValueError, match="256"):
        train.main(["--arch", "granite_3_2b", "--device", "cpu", "--mesh", "2,1",
                    "--production-mesh"])


@pytest.fixture
def isolated_profiles(tmp_path, monkeypatch):
    monkeypatch.setenv(thw.ENV_PROFILE_DIR, str(tmp_path))
    before = dict(thw._PROFILES)
    tpc.reset()
    yield tmp_path
    thw._PROFILES.clear()
    thw._PROFILES.update(before)
    tpc.reset()


def test_tune_train_probes_and_warms_backward_triples(isolated_profiles, capsys):
    import json
    from repro_torch.tools import tune
    rc = tune.main(["--device", "cpu", "--hardware", "cpu_host", "--shape", "48,64,96",
                    "--reps", "1", "--warmup", "0", "--name", "train_autotuned", "--train",
                    "--warm-workload", "granite_3_2b"])
    assert rc == 0
    assert "fwd+bwd triples" in capsys.readouterr().out
    meta = json.load(open(thw.profile_path("train_autotuned")))["_metadata"]
    probed = {(p["M"], p["K"], p["N"]) for p in meta["probes"]}
    assert {(48, 64, 96), (48, 96, 64), (64, 48, 96)} <= probed
    cache = tpc.PlanCache(path=str(isolated_profiles / "train_autotuned.plans.json"))
    from repro_torch.core.workloads import warm_shapes
    M_, K_, N_ = warm_shapes("granite_3_2b")[0]
    for shape in [(M_, K_, N_), *tfalcon.backward_shapes(M_, K_, N_)]:
        assert cache.has_shape(*shape), shape
