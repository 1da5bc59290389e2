"""Rank bodies of the port's multi-device tests.

``repro_torch.parallel.mesh.run_ranks`` spawns one process per rank of a
gloo mesh of CPU processes and runs one of these functions there with the
rank's mesh ambient; each returns plain data (numpy arrays, numbers,
strings) to the test. The module imports no JAX, so a rank starts in
seconds.
"""
import types

import numpy as np
import torch

import repro_torch.api as falcon
from repro_torch.convert import params_from_numpy
from repro_torch.core import plan_cache
from repro_torch.core.autotune import autotune, measure_collective_bw
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import moe
from repro_torch.parallel import collectives, sharding
from repro_torch.serve import ServeEngine


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
