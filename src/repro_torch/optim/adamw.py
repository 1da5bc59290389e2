"""AdamW on the port's parameter trees, with explicit state tensors.

The state mirrors the parameter tree: ``m`` and ``v`` in ``state_dtype``
(float32) beside bf16 or f32 parameters, on the parameters' device, and
``step`` (an int32 scalar) — the reference's keys, so a checkpoint of one
package's state restores in the other. No ``torch.optim``: the update is
the reference's arithmetic, leaf by leaf, and rounds a parameter where the
reference does (``(p.f32 - lr * delta).to(p.dtype)``).

The update works in place on the parameters and the state, as the
reference's jitted step does on the buffers it donates: a leaf that
requires grad stays the same tensor across steps, and no second copy of
the state exists at any time. int8 B̃q is not trained:
``refresh_planned_params`` re-bakes it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero ``m`` and ``v`` (``cfg.state_dtype``) for every float leaf of
    ``params`` (None for the others), and ``step`` 0, on the params' device."""
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device) if p.is_floating_point() else None

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads, mesh=None, placement=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum of
    squares; None leaves count as zero. On a ``mesh`` with the leaves'
    ``placement`` (``parallel.sharding.param_sharding``, mirroring
    ``grads``) the norm is the whole tree's: the sums of the leaves split
    over the same axes are added, and each such partial sum is all-reduced
    over those axes (one collective per set of axes, in a fixed order on
    every rank); a leaf held whole counts once. The reference's GSPMD
    gives it this for free."""
    if mesh is None or placement is None:
        sq = None
        for g in tree_leaves(grads):
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        return torch.sqrt(sq) if sq is not None else torch.zeros(())
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.mesh import AXES
    from repro_torch.parallel.sharding import gathered_axes
    parts: dict[tuple, torch.Tensor] = {}

    def add(g, where):
        axes = tuple(a for a in AXES if a in gathered_axes(where) and mesh.size(a) > 1)
        s = torch.sum(torch.square(g.float()))
        parts[axes] = s if axes not in parts else parts[axes] + s

    tree_map(add, grads, placement)
    sq = None
    for axes in sorted(parts):
        s = C.all_reduce(parts[axes], mesh, axes) if axes else parts[axes]
        sq = s if sq is None else sq + s
    return torch.sqrt(sq) if sq is not None else torch.zeros(())


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float, mesh=None, placement=None):
    """(grads scaled so their global norm is at most ``max_norm``, each
    rounded back to its dtype; the norm before clipping). On a ``mesh``,
    the norm of the whole tree of which ``grads`` are this rank's shards
    (:func:`_global_norm`)."""
    gnorm = _global_norm(grads, mesh, placement)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0, mesh=None,
                 placement=None):
    """One AdamW step with global-norm clipping: returns (params, state,
    metrics), the first two updated in place (the same objects). ``grads``
    mirrors ``params``; a None gradient counts as zeros, as the reference's
    gradient of an unused leaf is (weight decay still applies). Non-float
    leaves (int8 B̃q) pass through. On a ``mesh`` each rank updates its
    shards in place, clipped by the whole tree's norm (``placement``)."""
    gnorm = _global_norm(grads, mesh, placement)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["step"] += 1
    step = state["step"].float()
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p
        g32 = (torch.zeros_like(p, dtype=torch.float32) if g is None
               else (g.float() * scale).to(g.dtype).float())
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr.to(p.device) * delta).to(p.dtype))
        return p

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, state, {"grad_norm": gnorm}
