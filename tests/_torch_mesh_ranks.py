"""Rank bodies of the port's multi-device tests.

``repro_torch.parallel.mesh.run_ranks`` spawns one process per rank of a
gloo mesh of CPU processes and runs one of these functions there with the
rank's mesh ambient; each returns plain data (numpy arrays, numbers,
strings) to the test. The module imports no JAX, so a rank starts in
seconds.
"""
import dataclasses
import types

import numpy as np
import torch

import repro_torch.api as falcon
from repro_torch.convert import params_from_numpy
from repro_torch.core import plan_cache
from repro_torch.checkpoint import CheckpointManager, gather_state, restore_checkpoint
from repro_torch.core.autotune import autotune, measure_collective_bw
from repro_torch.core.falcon_gemm import SHARD_MAP_LOCAL, falcon_dense
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as M, moe
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.compression import compressed_psum_mean, psum_mean
from repro_torch.serve import ServeEngine
from repro_torch.train.steps import (loss_and_grads, make_compressed_dp_train_step,
                                     make_train_step, warm_train)


def engine_run(mesh, cfg, np_params, requests, kw):
    """The continuous engine on this rank: warm, the requests, and what it
    served (tokens, per-step logits, plan misses after warm, summary)."""
    plan_cache.reset()
    engine = ServeEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"), device="cpu",
                         mesh_shape={"data": 1, "model": mesh.size("model")}, **kw)
    engine.warm()
    misses = plan_cache.stats().misses
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in requests]
    engine.run()
    return {"tokens": [r.generated for r in reqs],
            "logits": [np.stack(r.logits) for r in reqs],
            "misses_after_warm": plan_cache.stats().misses - misses,
            "summary": engine.summary()}


def oneshot_run(mesh, cfg, kw):
    """``run_oneshot`` on this rank of a ``{"model": m}`` mesh."""
    res = run_oneshot(cfg, device="cpu", mesh_shape={"model": mesh.size("model")}, **kw)
    return {"tokens": res["tokens"].numpy(),
            "logits": [lg.float().numpy() for lg in res["logits"]],
            "n_precombined": res["n_precombined"], "mesh": res["mesh"]}


def moe_layer_run(mesh, np_p, x, top_k, capacity_factor, mode):
    """One MoE layer, expert-parallel: this rank's shard of the router and
    expert stacks (the rule table's placement), ``moe_apply`` on it."""
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in np_p.items()}
    E = p["router"].shape[-1]
    local = sharding.shard_params(p, types.SimpleNamespace(num_heads=1, num_kv_heads=1),
                                  mesh)
    with falcon.use(falcon.FalconConfig(mode=mode)), torch.inference_mode():
        y, aux = moe.moe_apply(local, torch.from_numpy(x), top_k, capacity_factor,
                               num_experts=E)
    return {"y": y.numpy(), "aux": float(aux), "held": local["router"].shape[-1],
            "calls": dict(mesh.stats.calls)}


def collectives_run(mesh):
    """all_reduce and all_gather of rank-dependent bf16 and f32 tensors."""
    r = mesh.local_rank("model")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(6, dtype=dt).reshape(2, 3) + 10 * r
        out[str(dt)] = (collectives.all_reduce(x, mesh).float().numpy(),
                        collectives.all_gather(x, mesh, dim=-1).float().numpy(),
                        collectives.all_gather(x, mesh, dim=0).float().numpy(), x.float().numpy())
    out["stats"] = mesh.stats.as_dict()
    return out


def graphs_refused(mesh, cfg):
    """The refusal a gloo mesh gives CUDA graphs, as text (the device is
    'cuda', so the check runs before any card is needed)."""
    try:
        ServeEngine(cfg, mesh_shape={"model": mesh.size("model")}, device="cuda",
                    cuda_graphs=True)
    except ValueError as e:
        return str(e)
    return None


def collective_probe(mesh):
    """``measure_collective_bw`` over the mesh's ranks."""
    return measure_collective_bw(size_bytes=1 << 16, reps=1, warmup=0)


def autotune_collectives(mesh, name):
    """``autotune(collectives=True)`` on a tiny probe: (the measured rate,
    the calibrated profile's ``collective_bw``, whether it was recorded)."""
    report = autotune(base="cpu_host", backend="torch", shapes=[(64, 64, 64)], reps=1,
                      warmup=0, validate=False, collectives=True, device="cpu", name=name)
    return report.collective_bw, report.profile.collective_bw, report.collective_recorded


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def suite(mesh, jobs):
    """Several rank bodies in one spawn: ``jobs`` is a list of (name, body,
    args); each body runs with the collectives' counters reset, and the
    results come back by name."""
    out = {}
    for name, fn, args in jobs:
        mesh.stats.reset()
        out[name] = globals()[fn](mesh, *args)
    return out


def train_mesh_run(mesh, cfg, np_params, data_kw, steps, opt_kw, mode):
    """``cfg`` trained on this rank (placed by ``make_rules(mesh,
    fsdp=cfg.fsdp, style=cfg.parallel_style)``, its rows of the global
    batch from ``SyntheticLMData`` over the loss axes): the loss and every
    gradient of the first step gathered whole, plan misses after
    ``warm_train``, then ``steps`` AdamW steps on that batch and the
    parameters gathered whole; the hook's decisions and the collectives."""
    plan_cache.reset()
    SHARD_MAP_LOCAL.clear()
    params = params_from_numpy(np_params, cfg, device="cpu")
    rules = sharding.make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)
    placement = sharding.param_sharding(params, mesh, rules, cfg)
    local = sharding.shard_params(params, cfg, mesh, rules)
    del params
    data = SyntheticLMData(DataConfig(**data_kw), device="cpu", mesh=mesh,
                           batch_spec=sharding.loss_axes(cfg.parallel_style))
    batch = data.batch(0)
    fc = M.falcon_config_for(dataclasses.replace(cfg, falcon_mode=mode))
    opt = AdamWConfig(**opt_kw)
    with falcon.use(fc):
        warm_train(cfg, data_kw["global_batch"], data_kw["seq_len"], mesh_shape=mesh.shape)
        misses = plan_cache.stats().misses
        loss, _, grads = loss_and_grads(local, cfg, batch, mesh=mesh, placement=placement)
        out = {"loss": float(loss), "grads": _np(gather_state(grads, placement, mesh)),
               "misses_after_warm": plan_cache.stats().misses - misses}
        state = adamw_init(local, opt)
        step = make_train_step(cfg, opt, total_steps=steps + 1, warmup=1, mesh=mesh,
                               placement=placement)
        norms = []
        for i in range(1, steps + 1):
            local, state, m = step(local, state, batch, i)
            norms.append(float(m["grad_norm"]))
    out.update(params=_np(gather_state(local, placement, mesh)), grad_norms=norms,
               hook=dict(SHARD_MAP_LOCAL), stats=mesh.stats.as_dict(),
               local_shapes={k: tuple(v.shape) for k, v in local["layers"]["attn"].items()})
    return out


def autograd_collectives_run(mesh):
    """reduce_scatter, all_reduce(op="max"), and the gradients of the
    autograd forms (all_gather with each backward, copy_to_axis, the
    row-parallel all_reduce) of rank-dependent tensors."""
    r = mesh.rank
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) * (r + 1)
    out = {"reduce_scatter": collectives.reduce_scatter(x, mesh, "data", dim=0).numpy(),
           "reduce_scatter/dim1": collectives.reduce_scatter(
               x.T.to(torch.bfloat16), mesh, "data", dim=1).float().numpy(),
           "max": collectives.all_reduce(x, mesh, "data", op="max").numpy()}
    w = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r).requires_grad_(True)
    for mode in ("reduce_scatter", "slice"):
        full = collectives.all_gather(w, mesh, "data", dim=0, backward=mode)
        (g,) = torch.autograd.grad(torch.sum(full * (r + 1)), [w])
        out[f"gather/{mode}"] = g.numpy()
    y = collectives.copy_to_axis(w, mesh, "data")
    (g,) = torch.autograd.grad(torch.sum(y * (r + 1)), [w])
    out["copy_to_axis"] = g.numpy()
    z = collectives.all_reduce(w, mesh, "data")
    (g,) = torch.autograd.grad(torch.sum(z * (r + 1)), [w])
    out["all_reduce"] = (z.detach().numpy(), g.numpy())
    out["calls"] = dict(mesh.stats.calls)
    return out


def compressed_run(mesh, grads_by_rank):
    """``compressed_psum_mean`` and the exact ``psum_mean`` of this rank's
    numpy gradients."""
    g = {k: torch.from_numpy(v[mesh.rank]) for k, v in grads_by_rank.items()}
    comp = compressed_psum_mean(g, mesh, ("data",))
    exact = psum_mean(g, mesh, ("data",))
    return {"comp": _np(comp), "exact": _np(exact), "stats": mesh.stats.as_dict()}


def compressed_train_run(mesh, cfg, np_params, data_kw, steps):
    """The compressed-DP step at warmup 1 on a fixed batch: the losses."""
    params = params_from_numpy(np_params, cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    batch = SyntheticLMData(DataConfig(**data_kw), device="cpu", mesh=mesh).batch(0)
    step = make_compressed_dp_train_step(cfg, opt, mesh, warmup=1)
    losses = []
    with falcon.use(M.falcon_config_for(cfg)):
        for s in range(steps):
            params, state, m = step(params, state, batch, s)
            losses.append(float(m["loss"]))
    return {"losses": losses, "calls": dict(mesh.stats.calls)}


def shard_map_local_run(mesh, x, w, mode, replicated_only):
    """The ``shard_map_local`` hook on this rank's rows of ``x`` against
    ``w`` under ``fsdp_only``: its output and the gradient of sum(out**2)
    with respect to ``w`` (summed over the ranks), and its decisions.
    ``replicated_only`` restricts the FSDP layouts the hook prices to the
    replicated one."""
    from repro_torch.core import decision
    if replicated_only:
        decision.fsdp_layouts = lambda: (decision.layout_by_name("gathered"),)
    SHARD_MAP_LOCAL.clear()
    nb = mesh.n_devices
    rows = x.shape[0] // nb
    xl = torch.from_numpy(x[mesh.rank * rows:(mesh.rank + 1) * rows])
    wt = torch.from_numpy(w).requires_grad_(True)
    cfg = falcon.FalconConfig(mode=mode, backend="shard_map_local")
    with sharding.use_parallel_style("fsdp_only"):
        out = falcon_dense(xl, wt, cfg)
        (g,) = torch.autograd.grad(torch.sum(out ** 2), [wt])
    g = collectives.all_reduce(g, mesh, ("data", "model"))
    return {"out": out.detach().numpy(), "grad": g.numpy(), "hook": dict(SHARD_MAP_LOCAL)}


def data_run(mesh, data_kw, spec, step):
    """This rank's rows of ``SyntheticLMData.batch(step)`` over ``spec``."""
    b = SyntheticLMData(DataConfig(**data_kw), device="cpu", mesh=mesh,
                        batch_spec=spec).batch(step)
    return {k: v.numpy() for k, v in b.items()}


def checkpoint_save_run(mesh, cfg, np_params, directory):
    """Save ``{"params"}`` sharded on this mesh (FSDP rules) through
    ``CheckpointManager``: rank 0 writes the whole arrays."""
    params = params_from_numpy(np_params, cfg, device="cpu")
    rules = sharding.make_rules(mesh, fsdp=True)
    placement = sharding.param_sharding(params, mesh, rules, cfg)
    local = sharding.shard_params(params, cfg, mesh, rules)
    ck = CheckpointManager(directory, async_save=False, mesh=mesh,
                           placement={"params": placement})
    ck.save(3, {"params": local})
    ck.wait()
    return {k: tuple(v.shape) for k, v in local["layers"]["attn"].items()}


def checkpoint_restore_run(mesh, cfg, np_params, directory):
    """Restore that checkpoint onto this mesh (FSDP rules), then gather it
    whole again: (whole tree, the local shapes)."""
    like = {"params": params_from_numpy(np_params, cfg, device="cpu")}
    rules = sharding.make_rules(mesh, fsdp=True)
    tree, step, _ = restore_checkpoint(directory, like, mesh=mesh, rules=rules, cfg=cfg)
    placement = sharding.param_sharding(like, mesh, rules, cfg)
    whole = gather_state(tree, placement, mesh)
    return {"step": step, "tree": _np(whole),
            "local": {k: tuple(v.shape) for k, v in tree["params"]["layers"]["attn"].items()}}


def moe_train_layer_run(mesh, np_p, x, top_k, capacity):
    """One MoE layer expert-parallel over "model" with the tokens over
    "data" (the TP table's placement): its output on this rank's tokens,
    and the gradients of the sum over every rank's tokens of y**2 (the
    experts' and router's summed over "data", then gathered whole; this
    rank's tokens')."""
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in np_p.items()}
    E = p["router"].shape[-1]
    cfg = types.SimpleNamespace(num_heads=1, num_kv_heads=1)
    rules = sharding.make_rules(mesh)
    placement = sharding.param_sharding(p, mesh, rules, cfg)
    local = sharding.shard_params(p, cfg, mesh, rules)
    rows = x.shape[0] // mesh.size("data")
    lo = mesh.local_rank("data") * rows
    xl = torch.from_numpy(x[lo:lo + rows]).requires_grad_(True)
    leaves = [local[k].requires_grad_(True) for k in sorted(local)]
    with falcon.use(falcon.FalconConfig(mode="gemm")):
        y, aux = moe.moe_apply(local, xl, top_k, 1.25, deterministic_capacity=capacity,
                               num_experts=E)
        gs = torch.autograd.grad(torch.sum(y ** 2), [xl, *leaves])
    grads = {k: collectives.all_reduce(g, mesh, "data") for k, g in zip(sorted(local), gs[1:])}
    return {"y": y.detach().numpy(), "dx": gs[0].numpy(), "aux": float(aux),
            "grads": _np(gather_state(grads, placement, mesh)),
            "held": local["router"].shape[-1], "calls": dict(mesh.stats.calls)}
