"""One rank's arguments for every (arch x shape-cell) dry-run cell, on ``meta``.

Everything here is shape-only (no allocation): the parameters are the real
``init_params`` on the ``meta`` device, sharded to this rank's part by the
rule table (``parallel.sharding``), the AdamW state is ``adamw_init`` of
them, and the inputs (token rows, a vlm's patch embeddings, the decode cache)
are this rank's rows. The dry run (``launch/dryrun.py``) runs the port's own
train, prefill and decode steps on them. The counterpart of the reference's
ShapeDtypeStruct specs: the reference attaches NamedShardings to global
shapes, the port holds each rank's shard explicitly, so the per-rank bytes
are those of the tensors themselves.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import mesh as PM, sharding as SH
from repro_torch.tree import tree_leaves

__all__ = ["cell_applicable", "input_specs", "abstract_state", "CellSpec", "tree_bytes"]


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention")
    return True, ""


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (a parameter tree, or a tuple
    of them; None and int leaves count 0)."""
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(t) for t in tree)
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class CellSpec:
    kind: str                 # train | prefill | decode
    args: tuple               # the step function's positional arguments
    params: object            # this rank's parameter shards (meta)
    opt_state: object | None
    rules: SH.ShardingRules
    placement: object         # ``param_sharding`` of the whole tree
    n_params: int
    n_active_params: int
    arg_bytes: dict           # this rank's bytes: params, opt, inputs

    @property
    def argument_bytes(self) -> int:
        return sum(self.arg_bytes.values())


def abstract_state(cfg: ModelConfig, mesh, need_opt: bool, opt_dtype: str = "float32"):
    """This rank's parameter shards and AdamW state on ``meta``, the rules
    and placement, and the (total, active) parameter counts of the whole
    model (MoE experts count k/E of their size)."""
    rules = SH.make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)
    full = M.init_params(cfg, 0, device="meta")
    total = expert = 0

    def count(tree, path):
        nonlocal total, expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                count(v, f"{path}/{k}")
            return
        total += tree.numel()
        if "moe_" in path:
            expert += tree.numel()

    count(full, "")
    active = total - expert
    if cfg.num_experts:
        active += expert * cfg.experts_per_token // cfg.num_experts
    placement = SH.param_sharding(full, mesh, rules, cfg)
    params = SH.shard_params(full, cfg, mesh, rules)
    opt = adamw_init(params, AdamWConfig(state_dtype=opt_dtype)) if need_opt else None
    return params, opt, rules, placement, total, active


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh, opt_dtype: str = "float32") -> CellSpec:
    """This rank's arguments for ``cell``: the batch rows split over the
    batch axes (under ``fsdp_only`` "model" too) where the global batch
    divides them, else held whole by every rank (``long_500k``'s batch of
    one). A decode cell's cache is ``init_cache`` of the rank's rows at
    the cell's length, holding the rank's KV heads."""
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        raise ValueError(f"{cfg.name} x {cell.name} skipped: {why}")
    params, opt, rules, placement, total, active = abstract_state(
        cfg, mesh, need_opt=cell.kind == "train", opt_dtype=opt_dtype)
    axes = SH.loss_axes(cfg.parallel_style)
    nb = mesh.size(axes)
    B, S = cell.global_batch, cell.seq_len
    b = B // nb if B % nb == 0 else B

    def tokens(s):
        shape = (b, s, cfg.num_codebooks) if cfg.frontend == "audio_codebooks" else (b, s)
        return torch.zeros(shape, dtype=torch.long, device="meta")

    def patches():
        return torch.zeros((b, cfg.num_patches, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                           device="meta")

    vlm = cfg.frontend == "vision_patches"
    s_text = S - cfg.num_patches if vlm else S
    if cell.kind == "train":
        batch = {"tokens": tokens(s_text), "labels": tokens(s_text)}
        if vlm:
            batch["patch_embeds"] = patches()
        args = (params, opt, batch, 0)
        inputs = batch
    elif cell.kind == "prefill":
        args = (params, tokens(s_text)) + ((patches(),) if vlm else ())
        inputs = args[1:]
    else:
        # one new token against an S-long cache of the rank's rows and KV heads
        with PM.use_mesh(mesh):
            cache = M.init_cache(cfg, b, S, device="meta")
        args = (params, cache, tokens(1), S - 1)
        inputs = (cache, args[2])
    arg_bytes = {"params": tree_bytes(params), "opt": tree_bytes(opt),
                 "inputs": tree_bytes(inputs)}
    return CellSpec(cell.kind, args, params, opt, rules, placement, total, active, arg_bytes)

