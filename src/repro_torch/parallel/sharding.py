"""Mesh-axis conventions and parameter/activation sharding rules.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod. The "pod" axis is pure data parallelism across pods, "data" is
DP/FSDP inside a pod, "model" is tensor/expert parallelism.

Parameters are sharded by *path-pattern rules* (T5X/MaxText style): a table of
regexes over the flattened param path decides each leaf's spec, a tuple of
one mesh axis (or None) per dim, copied from the reference's table.
``fsdp=True`` additionally shards the non-model dimension of large matrices
over "data" (ZeRO-3 style parameter sharding); ``seq_shard=True`` turns on
sequence/context parallelism for long-context cells.

The reference hands these specs to GSPMD, which partitions global arrays.
The port runs SPMD with explicit collectives instead: :func:`param_sharding`
places each leaf by the table and :func:`shard_params` slices each rank's
shard, so every rank holds and contracts local shapes. Two placements
differ from the table's, because explicit tensor parallelism cannot split
what GSPMD can. An attention block is split by whole heads
(:func:`attention_split`): where the query and KV head counts both divide
the model axis, each rank takes its share of both; where only the query
heads do (granite's 8 KV heads on 16 ranks), each rank takes its q heads
(``w_q``'s columns, ``w_o``'s rows) and holds ``w_k``/``w_v`` whole, as the
reference's activation spec gives every rank the whole K/V there; where
the query heads do not divide (the reference shards ``w_q`` on H*hd
wherever that divides, which splits hymba's 25 heads of 64 across 2
ranks), every rank holds the block whole. And an SSD mixer is held whole
(its in-projection concatenates z, x, B, C and dt, which a column split
does not separate). A mesh is anything with ``axis_names`` and a ``shape``
mapping, or a plain ``{axis: size}`` dict.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re

import torch

__all__ = ["ShardingRules", "batch_axes", "param_sharding", "activation_specs",
           "make_rules", "layouts_for_mesh", "shard_params", "shard_act",
           "attention_split", "BATCH", "set_parallel_style", "get_parallel_style",
           "use_parallel_style", "resolve_batch_axes", "shard_leaf", "gather_param",
           "gather_tree", "unstack_placement", "use_placement", "current_placement",
           "fsdp_dims", "gathered_axes", "ambient_state", "use_ambient_state", "loss_axes"]


def _sizes(mesh) -> dict[str, int]:
    return {str(k): int(v) for k, v in (mesh if isinstance(mesh, dict) else mesh.shape).items()}


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.axis_names)


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Compiled rule table: list of (path_regex, spec of the trailing dims)."""

    rules: tuple[tuple[str, tuple], ...]
    batch: tuple[str, ...]
    axis_sizes: tuple[tuple[str, int], ...] = ()
    seq_shard: bool = False
    style: str = "tp"

    def _fits(self, dim: int, axis) -> bool:
        sizes = dict(self.axis_sizes)
        axes = axis if isinstance(axis, tuple) else (axis,)
        total = math.prod(sizes.get(a, 1) for a in axes)
        return dim % total == 0

    def spec_for(self, path: str, shape: tuple[int, ...]) -> tuple:
        for pat, spec in self.rules:
            if re.search(pat, path):
                # rules are written for the param's trailing dims; stacked
                # per-layer params carry a leading L dim which is unsharded.
                if len(spec) < len(shape):
                    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
                elif len(spec) > len(shape):
                    spec = tuple(spec)[-len(shape):]
                # drop axes that do not divide the dim (e.g. 5 KV heads vs a
                # 16-way model axis, vocab 49155 vs 16-way data axis).
                return tuple(
                    a if a is not None and self._fits(shape[i], a) else None
                    for i, a in enumerate(spec))
        return ()  # replicate by default (norm scales, biases, ...)


def make_rules(mesh, fsdp: bool = False, seq_shard: bool = False,
               style: str = "tp") -> ShardingRules:
    axis_sizes = tuple((n, s) for n, s in _sizes(mesh).items())
    if style == "fsdp_only":
        # no tensor parallelism: batch over every axis, params ZeRO-3-sharded
        # over (data x model) on their first (largest) dim.
        b = batch_axes(mesh) + ("model",)
        fs2 = ("data", "model")
        table = [
            (r"embed|lm_head|w_q|w_qkv|w_k|w_v|w_o|mlp_|moe_|router|ssm_in|ssm_out|frontend",
             (fs2, None)),
        ]
        return ShardingRules(tuple(table), b, axis_sizes, seq_shard, style)
    b = batch_axes(mesh)
    fs = "data" if fsdp else None
    # NOTE: order matters — first match wins.
    table = [
        # embeddings / tied lm head: vocab over model (=> logits shard over
        # vocab, no (T,V) all-reduce), embed dim unsharded
        (r"embed", ("model", fs)),
        (r"lm_head", (fs, "model")),
        # attention projections
        (r"\bw_q\b|w_qkv|w_kv|\bw_k\b|\bw_v\b", (fs, "model")),
        (r"\bw_o\b", ("model", fs)),
        # MoE: experts over model; per-expert matrices over fsdp/None
        (r"moe_(gate|up)", ("model", fs, None)),
        (r"moe_down", ("model", None, fs)),
        (r"router", (fs, "model")),
        # dense MLP
        (r"mlp_(gate|up)", (fs, "model")),
        (r"mlp_down", ("model", fs)),
        # mamba/SSD: inner channels over model
        (r"ssm_in", (fs, "model")),
        (r"ssm_out", ("model", fs)),
        (r"ssm_(A|D|dt_bias)", ("model",)),
        (r"conv_w", (None, "model")),
        # patch/frame stub frontends
        (r"frontend", (fs, "model")),
    ]
    return ShardingRules(tuple(table), b, axis_sizes, seq_shard)


def attention_split(num_heads: int, num_kv_heads: int, model: int) -> tuple[int, int]:
    """How many ways an attention block's query heads and its KV heads
    split over a ``model``-way axis, whole heads only: ``(model, model)``
    where both head counts divide it; ``(model, 1)`` where only the query
    heads do (each rank its q heads, K/V whole: the KV heads a rank's q
    heads read are not an even shard of them); ``(1, 1)`` otherwise (the
    block whole)."""
    if model <= 1 or num_heads % model:
        return 1, 1
    return model, (model if num_kv_heads % model == 0 else 1)


def param_sharding(params, mesh, rules: ShardingRules, cfg) -> dict:
    """Each leaf's placement: a tuple of ``(dim, axis)`` pairs, one per
    sharded dim (empty: held whole on every rank; ``axis`` one mesh axis or
    a tuple of them), in the tree's structure. The table's spec
    (:meth:`ShardingRules.spec_for` on the leaf's path, ``layers/attn/w_q``),
    except that under tensor parallelism attention is split by whole heads
    (:func:`attention_split`: ``w_k``/``w_v`` whole where only the query
    heads split, the whole block where they do not) and every SSD mixer is
    not split over "model" (module docstring); their placements over
    "data" (FSDP) stay. ``cfg`` gives the head counts."""
    q_ways, kv_ways = attention_split(cfg.num_heads, cfg.num_kv_heads,
                                      _sizes(mesh).get("model", 1))
    tp = rules.style == "tp"

    def place(tree, path):
        if isinstance(tree, dict):
            return {k: place(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        parts = path.split("/")
        spec = rules.spec_for(path, tuple(tree.shape))
        ways = (kv_ways if parts[-1] in ("w_k", "w_v") else q_ways) if "attn" in parts else 0
        whole = tp and ("ssm" in parts or ways == 1)
        return tuple((i, a) for i, a in enumerate(spec)
                     if a is not None and not (whole and a == "model"))

    return place(params, "")


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def shard_leaf(t: torch.Tensor, where, mesh) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` under the placement
    ``where`` (``(dim, axis)`` pairs): a contiguous copy, or ``t`` itself
    where nothing is sharded over more than one rank."""
    cut = False
    sizes = _sizes(mesh)
    for dim, axis in where:
        n = math.prod(sizes[a] for a in _axes(axis))
        if n <= 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"shard_leaf: dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} ranks of {axis}")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.local_rank(axis) * size, size)
        cut = True
    return t.contiguous() if cut else t


def shard_params(params, cfg, mesh, rules: ShardingRules | None = None) -> dict:
    """This rank's shard of every leaf (raw tensors, before precombining),
    placed by :func:`param_sharding` under ``rules`` (default: the
    tensor-parallel table of ``mesh``). Each shard is a contiguous copy, so
    the full tree can be freed. A placement over "data" (``fsdp``) or over
    ``("data", "model")`` (``fsdp_only``) is a ZeRO-3 shard: the model
    gathers it at use (:func:`gather_param`) under :func:`use_placement`."""
    rules = rules or make_rules(mesh)
    placement = param_sharding(params, mesh, rules, cfg)

    def walk(tree, where):
        if isinstance(tree, dict):
            return {k: walk(v, where[k]) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"shard_params takes raw tensors (shard before precombining); "
                            f"got {type(tree).__name__}")
        return shard_leaf(tree, where, mesh)

    return walk(params, placement)


def fsdp_dims(where) -> tuple:
    """The ZeRO-3 part of a placement: its pairs over any axis but "model"
    alone (tensor parallelism's, which the model reads from the shapes)."""
    return tuple((d, a) for d, a in where if a != "model")


def gathered_axes(where) -> set[str]:
    """The mesh axes a leaf placed by ``where`` is split over."""
    return {a for _, axis in where for a in _axes(axis)}


def gather_param(t: torch.Tensor, where, mesh) -> torch.Tensor:
    """The FSDP weight at use: ``t`` all-gathered over each ZeRO-3 pair of
    its placement (:func:`fsdp_dims`), whose backward reduce-scatters the
    gradient back to this rank's shard. ``t`` itself where there is none."""
    from .collectives import all_gather
    for dim, axis in fsdp_dims(where):
        if mesh.size(axis) > 1:
            t = all_gather(t, mesh, axis, dim=dim)
    return t


def gather_tree(tree, where, mesh):
    """:func:`gather_param` of every leaf of ``tree`` (``where`` mirrors it)."""
    if where is None or mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, where[k], mesh) for k, v in tree.items()}
    return gather_param(tree, where, mesh)


def unstack_placement(where):
    """The placement of one layer's slice of a stacked per-layer tree: each
    pair's dim less the leading layer dim."""
    if isinstance(where, dict):
        return {k: unstack_placement(v) for k, v in where.items()}
    if any(d == 0 for d, _ in where):
        raise ValueError(f"a placement {where} splits the stacked layer dim")
    return tuple((d - 1, a) for d, a in where)


_PLACEMENT_CTX = contextvars.ContextVar("repro_torch_placement", default=None)


@contextlib.contextmanager
def use_placement(placement):
    """Make ``placement`` (:func:`param_sharding` of the whole tree) the
    ambient one inside the block: the model gathers every ZeRO-3 shard of
    its params by it at use. None: nothing is gathered."""
    token = _PLACEMENT_CTX.set(placement)
    try:
        yield placement
    finally:
        _PLACEMENT_CTX.reset(token)


def current_placement():
    """The ambient placement (:func:`use_placement`), or None."""
    return _PLACEMENT_CTX.get()


_STYLE_CTX = contextvars.ContextVar("repro_torch_parallel_style", default="tp")

# sentinel resolved by shard_act according to the active parallel style
BATCH = "BATCH"


def set_parallel_style(style: str):
    """"tp" (default) or "fsdp_only". Returns a token for ContextVar.reset."""
    if style not in ("tp", "fsdp_only"):
        raise ValueError(f"unknown parallel style {style!r}")
    return _STYLE_CTX.set(style)


def get_parallel_style() -> str:
    return _STYLE_CTX.get()


@contextlib.contextmanager
def use_parallel_style(style: str):
    """:func:`set_parallel_style` inside the block."""
    token = set_parallel_style(style)
    try:
        yield style
    finally:
        _STYLE_CTX.reset(token)


def resolve_batch_axes() -> tuple[str, ...]:
    if _STYLE_CTX.get() == "fsdp_only":
        return ("pod", "data", "model")
    return ("pod", "data")


def loss_axes(style: str | None = None) -> tuple[str, ...]:
    """The mesh axes the global batch splits over under ``style`` (default:
    the ambient one): "data", and "model" too under ``fsdp_only``. A train
    step's loss is the mean over these ranks."""
    style = style or get_parallel_style()
    return ("data", "model") if style == "fsdp_only" else ("data",)


def ambient_state():
    """What the model reads from its thread's context: the ambient mesh,
    the parallel style and the placement. :func:`use_ambient_state`
    re-installs it where the context is not the forward's (a recompute in
    backward, on the autograd engine's thread)."""
    from .mesh import current_mesh
    return current_mesh(), get_parallel_style(), current_placement()


@contextlib.contextmanager
def use_ambient_state(state):
    from .mesh import use_mesh
    mesh, style, placement = state
    with use_parallel_style(style), use_mesh(mesh), use_placement(placement):
        yield


def layouts_for_mesh(mesh=None, style: str | None = None):
    """Candidate shard layouts for pricing a dense contraction on ``mesh``.

    Returns ``(n_devices, layouts)`` for the shard-aware Decision Module
    (``falcon_gemm.plan_sharded``). The rule table is the parallel style's:

      * ``"tp"``        — weights shard over the "model" axis; candidates are
        replicated / column-parallel (all-gather C) / row-parallel
        (all-reduce C), with D = model-axis size;
      * ``"fsdp_only"`` — activations shard over every batch axis; candidates
        are replicated (gather A and B) vs batch-sharded with a weight
        all-gather, with D = the product of batch-axis sizes.

    Without a mesh (``None``: the ambient mesh, ``parallel.mesh.use_mesh``)
    or with a trivial axis this degenerates to ``(1, (replicated,))`` — the
    local model.
    """
    from repro_torch.core import decision as dec
    from .mesh import current_mesh

    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        return 1, (dec.layout_by_name("replicated"),)
    style = style or get_parallel_style()
    sizes = _sizes(mesh)
    if style == "fsdp_only":
        axes = tuple(a for a in resolve_batch_axes() if a in sizes)
        d = math.prod(sizes[a] for a in axes) if axes else 1
        layouts = dec.fsdp_layouts()
    else:
        d = int(sizes.get("model", 1))
        layouts = dec.default_layouts()
    if d <= 1:
        return 1, (dec.layout_by_name("replicated"),)
    return d, layouts


def shard_act(x, *spec):
    """The identity. The reference constrains an activation's sharding for
    GSPMD here; the port's ranks already hold local activations (SPMD with
    explicit collectives), so there is nothing to constrain."""
    return x


def activation_specs(rules: ShardingRules) -> dict[str, tuple]:
    """Canonical activation specs (per dim: None, an axis, or a tuple of
    axes), as the reference constrains them."""
    if rules.seq_shard:
        # context parallelism: batch is tiny (e.g. 1); shard sequence over
        # "data" instead, keeping only the pod axis (if any) on batch.
        b = tuple(a for a in rules.batch if a == "pod")
        seq = "data"
    else:
        b, seq = rules.batch, None
    # one dim's axes as the reference's PartitionSpec holds them: none is
    # None, one is its name
    b = None if not b else b[0] if len(b) == 1 else b
    return {
        "tokens": (b, seq),
        "hidden": (b, seq, None),               # (B, S, d)
        "heads": (b, seq, "model", None),       # (B, S, H, hd)
        "kv_cache": (b, seq, "model", None),    # (B, S_max, Hkv, hd)
        "ffn": (b, seq, "model"),               # (B, S, d_ff)
        "logits": (b, seq, "model"),            # (B, S, V)
        "ssm_state": (b, "model", None, None),  # (B, H, N, P)
        "moe_buf": ("model", b, None),          # (E, C, d)
    }
