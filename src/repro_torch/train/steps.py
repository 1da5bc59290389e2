"""Step functions: train (forward + planned backward + AdamW) and eval,
and the serve path's one-shot prefill and decode, and the
continuous-batching engine's bucketed prefill, chunk prefill and
speculative verify. Only the one-shot prefill takes a vlm's patch
embeddings: the engine refuses the frontends, as the reference's does.

The serve steps run under ``torch.inference_mode`` and write their cache
in place. The engine's steps take per-row tensor offsets (``start``,
``index`` as (B,) tensors) and never a host int, so that on the card a step
can be captured as a CUDA graph. The train step differentiates
:func:`~repro_torch.models.model.lm_loss` with autograd: every LCMA-routed
contraction runs through a planned core (``core.engine``), whose backward
is two planned contractions on the same kernels. FalconGEMM policy is the
ambient config (``falcon.use``), else the model's own; each factory's
``fcfg`` keyword survives as a deprecated override, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import decision, engine, workloads
from repro_torch.core.falcon_gemm import plan_sharded
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.parallel import collectives as C, sharding as SH
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_compressed_dp_train_step", "make_eval_step",
           "loss_and_grads", "warm_train",
           "make_prefill_step",
           "make_serve_prefill_step", "make_chunk_prefill_step", "make_decode_step",
           "make_verify_step"]


def _under(fcfg):
    """A step decorator: the step runs under ``fcfg`` (``engine.maybe_use``:
    nothing when None), the factories' deprecated override."""
    def wrap(step):
        if fcfg is None:
            return step

        @functools.wraps(step)
        def run(*args, **kwargs):
            with engine.maybe_use(fcfg):
                return step(*args, **kwargs)
        return run
    return wrap


def warm_train(cfg: ModelConfig, batch: int, seq: int, mesh_shape: dict | None = None) -> int:
    """Pre-plan the forward AND backward shapes of every contraction of
    ``cfg`` at (batch, seq): dense projections, grouped MoE expert FFNs,
    attention score/value contractions and SSD chunk contractions, all from
    the workload registry (``core.workloads.contraction_set``). Run once
    before the first train step, every Decision-Module query of the step
    (the forward contractions and each planned core's backward pair) is a
    plan-cache hit. ``mesh_shape`` plans instead the shapes one rank of
    that mesh contracts in a step of the global batch ``batch`` under
    ``cfg.parallel_style`` (``workloads.resolve_contractions(local=True,
    train=True)``), and under the ``shard_map_local`` backend also the
    sharded decisions its hook prices. Returns the number of ``plan()``
    calls made."""
    fc = engine.active_config() or M.falcon_config_for(cfg)
    mesh_shape = mesh_shape if mesh_shape and math.prod(mesh_shape.values()) > 1 else None
    n = engine.warm_buckets(fc, cfg, [(batch, seq)], dtype=str(cfg.dtype), train=True,
                            mesh_shape=mesh_shape)
    if mesh_shape and fc.backend == "shard_map_local" and cfg.parallel_style == "fsdp_only":
        n += warm_shard_map_local(fc, cfg, batch, seq, mesh_shape)
    return n


def warm_shard_map_local(fc, cfg: ModelConfig, batch: int, seq: int, mesh_shape: dict) -> int:
    """Plan the sharded decision (``plan_sharded``) the ``shard_map_local``
    hook makes for each dense contraction of a step of the global batch on
    a ``mesh_shape`` mesh under ``fsdp_only``."""
    nb = math.prod(mesh_shape.values())
    n = 0
    for c in workloads.resolve_contractions(cfg, batch, seq):
        if c.kind == "dense":
            plan_sharded(c.m, c.k, c.n, dataclasses.replace(fc, shards=(1, 1, 1)),
                         str(cfg.dtype), n_devices=nb, layouts=decision.fsdp_layouts())
            n += 1
    return n


def loss_and_grads(params, cfg: ModelConfig, batch: dict, mesh=None, placement=None):
    """(loss, metrics, grads): ``grads`` mirrors ``params`` (zeros where a
    float leaf does not reach the loss, as the reference's gradient is;
    None for int8 B̃q). Every float leaf is made to require grad.

    On a ``mesh`` (``params`` this rank's shards, ``placement`` their
    ``param_sharding``, ``batch`` this rank's rows) the loss is the mean
    over the ranks the batch splits over (``sharding.loss_axes`` of
    ``cfg.parallel_style``): each rank differentiates its local mean over
    their number n, so a ZeRO-3 shard's gradient, reduce-scattered by its
    gather's backward, is already the global one, and a leaf held whole
    over those ranks has its gradient summed over them. The loss and the
    metrics returned are the means over those ranks."""
    leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    if mesh is None:
        loss, metrics = M.lm_loss(params, cfg, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    else:
        axes = SH.loss_axes(cfg.parallel_style)
        n = mesh.size(axes)
        with SH.use_parallel_style(cfg.parallel_style), SH.use_placement(placement):
            loss, metrics = M.lm_loss(params, cfg, batch)
            gs = torch.autograd.grad(loss / n, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)}
    grads = tree_map(lambda p: by_id.get(id(p)), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    loss = loss.detach()
    if mesh is not None:
        grads = _sum_replicated(grads, placement, mesh, axes)
        names = sorted(metrics)
        red = C.all_reduce(torch.stack([loss, *(metrics[k] for k in names)]), mesh, axes) / n
        loss, metrics = red[0], dict(zip(names, red[1:]))
    return loss, metrics, grads


def _sum_replicated(grads, placement, mesh, axes):
    """Each gradient summed over those of ``axes`` (of more than one rank)
    its leaf is not split over: ZeRO-3 shards are already reduced."""
    def red(g, where):
        held = SH.gathered_axes(where) if placement is not None else set()
        over = tuple(a for a in axes if a not in held and mesh.size(a) > 1)
        return C.all_reduce(g, mesh, over) if over else g

    return tree_map(red, grads, placement)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, total_steps: int = 10_000,
                    warmup: int = 100, fcfg=None, microbatches: int = 1, mesh=None,
                    placement=None):
    """Forward + planned backward + AdamW: ``train_step(params, opt_state,
    batch, step) -> (params, opt_state, metrics)``. The parameters and the
    optimizer state are updated in place (the reference's jitted step
    donates both), then every PlannedWeight's B̃ is re-derived from its
    updated raw weight (``refresh_planned_params``). ``microbatches > 1``
    accumulates gradients over that many slices of the batch in float32:
    activation memory scales with the slice while the optimizer sees the
    whole batch.

    On a ``mesh`` the step runs on this rank's shards (``placement``:
    their ``param_sharding``; None, every leaf whole) and its rows of the
    global batch, the gradients and loss as :func:`loss_and_grads` gives
    them, clipped by the whole tree's norm, each rank updating its shards
    and its part of the optimizer state."""
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_train_step")

    def grads_of(params, batch):
        return loss_and_grads(params, cfg, batch, mesh=mesh, placement=placement)

    @_under(fcfg)
    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            n = microbatches
            for v in batch.values():
                if v.shape[0] % n:
                    raise ValueError(f"batch of {v.shape[0]} rows does not split into "
                                     f"{n} microbatches")
            gacc = lsum = None
            for i in range(n):
                mb = {k: v.chunk(n)[i] for k, v in batch.items()}
                loss_i, _, g = grads_of(params, mb)
                gacc = (tree_map(lambda t: t.float(), g) if gacc is None
                        else tree_map(lambda a, b: a + b.float(), gacc, g))
                lsum = loss_i if lsum is None else lsum + loss_i
            grads = tree_map(lambda t: t / n, gacc)
            loss, metrics = lsum / n, {}
        lr_scale = cosine_schedule(step, warmup, total_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                             lr_scale=lr_scale, mesh=mesh, placement=placement)
        # planned gradients landed on each PlannedWeight's raw weight (B̃'s
        # is zero): re-derive B̃ so the next forward reads a consistent one
        params = engine.refresh_planned_params(params)
        return params, opt_state, {"loss": loss, "lr_scale": lr_scale, **metrics, **om}

    return train_step


def make_compressed_dp_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                                  bits: int = 8, fcfg=None, total_steps: int = 10_000,
                                  warmup: int = 100):
    """Pure-DP train step with the int``bits``-compressed gradient mean
    (``parallel.compression.compressed_psum_mean``), the reference's
    ``make_compressed_dp_train_step``: parameters replicated on every rank,
    the batch over the DP axes (this rank's rows), each rank's local
    gradients mean-reduced compressed, the loss the mean over the DP ranks;
    then AdamW on the (identical) replicated tree and
    ``refresh_planned_params``. The exact all-reduce never runs in its
    place."""
    from repro_torch.parallel.compression import compressed_psum_mean
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_compressed_dp_train_step")
    dp_axes = ("data",)

    @_under(fcfg)
    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = loss_and_grads(params, cfg, batch)
        grads = compressed_psum_mean(grads, mesh, dp_axes, bits=bits)
        n = mesh.size(dp_axes)
        loss = C.all_reduce(loss, mesh, dp_axes) / n
        lr_scale = cosine_schedule(step, warmup, total_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                             lr_scale=lr_scale)
        params = engine.refresh_planned_params(params)
        return params, opt_state, {"loss": loss, "lr_scale": lr_scale, **metrics, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, fcfg=None):
    """``eval_step(params, batch) -> {'loss', 'xent', 'aux'}``, no gradients."""
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_eval_step")

    @torch.no_grad()
    @_under(fcfg)
    def eval_step(params, batch):
        loss, metrics = M.lm_loss(params, cfg, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int, fcfg=None):
    """Single-pass prefill: fills a fresh KV cache AND returns last-token
    logits. The cache lives on the tokens' device. ``patch_embeds`` (B, P, d)
    is a vlm's image prefix; ``max_len`` must then count its P positions."""
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_prefill_step")

    @torch.inference_mode()
    @_under(fcfg)
    def prefill_step(params, tokens, patch_embeds=None):
        cache = M.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        return M.forward(params, cfg, tokens, patch_embeds=patch_embeds, cache=cache,
                         cache_index=0, logits_mode="last")

    return prefill_step


def _length_mask(tokens, last_index):
    """(B, S) float mask: 1 up to each row's ``last_index``, 0 on the right
    pad (the SSD mixer zeroes dt there, so the recurrent state is exact)."""
    steps = torch.arange(tokens.shape[1], device=tokens.device)
    return (steps[None, :] <= last_index[:, None]).float()


def _last_logits(params, cfg: ModelConfig, hidden, last_index):
    """Logits (B, 1, V) of each row's position ``last_index`` (B,): the LM
    head runs on those rows only, so the padded tail never reaches it."""
    h_last = torch.take_along_dim(hidden, last_index[:, None, None].long(), dim=1)
    return M.compute_logits(params, cfg, h_last)


def make_serve_prefill_step(cfg: ModelConfig, max_len: int, fcfg=None):
    """Prefill for bucketed serving: right-padded prompts, per-row last index.

    ``last_index`` (B,) selects each request's true final prompt position
    before the LM head. K/V written at pad positions lie above each row's
    length and are overwritten before decode validity admits them; a
    per-row length mask from ``last_index`` makes the SSM/hybrid recurrent
    state exact under the right padding (dt = 0 on pad positions). Returns
    (logits (B, 1, V), cache) with the cache sized to ``max_len``.
    """
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_serve_prefill_step")

    @torch.inference_mode()
    @_under(fcfg)
    def prefill_step(params, tokens, last_index):
        cache = M.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        hidden, cache = M.forward(params, cfg, tokens, cache=cache, cache_index=0,
                                  logits_mode="none",
                                  length_mask=_length_mask(tokens, last_index))
        return _last_logits(params, cfg, hidden, last_index), cache

    return prefill_step


def make_chunk_prefill_step(cfg: ModelConfig, fcfg=None):
    """One prefill *chunk* against existing slot-cache rows.

    A chunk resumes at per-row offset ``start`` (B,) in ``cache`` rows
    gathered from the engine's slot cache: positions ``[start, start+S)``
    are written this chunk, and attention validity admits exactly ``kpos <
    start + S`` (earlier chunks plus this one; stale K/V of a slot's
    previous occupant above that is masked until overwritten). SSM/hybrid
    recurrent state carries from chunk to chunk through the cache; it is
    zeroed here, in place, for first-chunk rows (``start == 0``), since a
    reused slot may still hold its previous occupant's state, and the
    length mask keeps the right pad out of it. ``start > 0`` on a fresh
    request also covers prefix-cache reuse: the snapshot was copied into
    the slot first and only the suffix runs. Intermediate chunks are full
    buckets (``last_index = S-1``); the final chunk is right-padded and
    ``last_index`` picks each row's true last position for the LM head.
    Returns (logits (B, 1, V), cache rows).
    """
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_chunk_prefill_step")

    @torch.inference_mode()
    @_under(fcfg)
    def chunk_step(params, cache, tokens, start, last_index):
        if "state" in cache:
            st = cache["state"]
            st.mul_((start > 0).to(st.dtype).view((1, -1) + (1,) * (st.ndim - 2)))
        hidden, cache = M.forward(params, cfg, tokens, cache=cache, cache_index=start,
                                  logits_mode="none",
                                  length_mask=_length_mask(tokens, last_index))
        return _last_logits(params, cfg, hidden, last_index), cache

    return chunk_step


def make_decode_step(cfg: ModelConfig, fcfg=None):
    """One-token decode against a KV cache at position ``index`` (an int, or
    a (B,) tensor of per-row positions). The cache is updated in place."""
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_decode_step")

    @torch.inference_mode()
    @_under(fcfg)
    def decode_step(params, cache, tokens, index):
        return M.forward(params, cfg, tokens, cache=cache, cache_index=index,
                         logits_mode="last")

    return decode_step


def make_verify_step(cfg: ModelConfig, fcfg=None):
    """Speculative verify: score γ+1 tokens in one forward, logits per row.

    ``tokens`` (B, γ+1) is ``[t_last, d_1 .. d_γ]`` per row, decoded against
    the KV cache at per-row ``index``. Causal masking makes row j's logits
    the sequential next-token distribution after ``t_last, d_1..d_j``, so
    the greedy accept rule reproduces non-speculative greedy decoding token
    for token. Returns (logits (B, γ+1, V), cache rows); rejected draft
    positions stay in the cache and are overwritten before validity admits
    them.
    """
    if fcfg is not None:
        engine.warn_deprecated_fcfg("make_verify_step")

    @torch.inference_mode()
    @_under(fcfg)
    def verify_step(params, cache, tokens, index):
        return M.forward(params, cfg, tokens, cache=cache, cache_index=index,
                         logits_mode="all")

    return verify_step
