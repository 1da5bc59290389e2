"""The collectives of multi-device serving and training, over a mesh axis.

``all_reduce`` sums a partial result (a row-parallel projection, the
vocab-sharded embedding, the expert-parallel MoE output) or takes its
maximum (``op="max"``), ``all_gather`` concatenates shards (the LM head's
vocab shards, the MoE router's logits, an FSDP weight at use) and
``reduce_scatter`` gives this rank its slice of a sum (an FSDP weight's
gradient), ``all_gather_rows`` concatenates the rows of several tensors in
one message (what a serving step's data rank wrote), each over the process group of one axis of a
:class:`~repro_torch.parallel.mesh.Mesh`, or of several axes together
(``("data", "model")``: the whole mesh). On a gloo mesh a CUDA tensor
crosses through a pinned host buffer: ``torch.distributed`` documents only
``broadcast`` and ``all_reduce`` as gloo's CUDA operations (torch 2.11's
gloo also gathers CUDA tensors), and gloo's CUDA path copies through host
memory itself, so one staged path serves every operation on every version
and its bytes are counted. A collective that fails raises; nothing
retries on another backend. On ``meta`` tensors (the dry run, whose process
group is the fake backend) there is no data: a collective counts its
payload, stages nothing and returns a meta tensor of its result's shape.

Under autograd the collectives are differentiable where a backward
exists (Megatron's *f* and *g*, ZeRO-3's gather):

* ``all_reduce`` (sum; *g*, after a row-parallel block): backward is the
  identity, since every rank of the axis computes the same gradient of
  the replicated result;
* ``copy_to_axis`` (*f*, before a column-parallel block): identity
  forward, all-reduce backward;
* ``all_gather``: backward ``"reduce_scatter"`` (an FSDP weight: each rank
  of the axis computed its own gradient, and this rank's shard gets its
  slice of their sum) or ``"slice"`` (a gather whose result feeds a
  replicated computation, the LM head's vocab shards: this rank's slice).

Each autograd function keeps its mesh, axis and dim on ``ctx``: backward
may run on the autograd engine's device thread, where no ambient state of
the forward's thread is set. A collective on a tensor that requires grad
outside these (``all_reduce(op="max")``) raises.

Each mesh counts its collectives (:class:`CollectiveStats`): calls by
operation (a backward's under ``<op>/bwd``), payload and staged bytes,
and milliseconds on the host clock (the staged copies included; a gloo
collective returns when it is done, an nccl one when it is queued), in
all and by operation.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch
import torch.distributed as dist

__all__ = ["CollectiveStats", "all_reduce", "all_gather", "all_gather_rows", "reduce_scatter",
           "copy_to_axis"]


@dataclasses.dataclass
class CollectiveStats:
    """Counters of one mesh's collectives since it was made (or ``reset``)."""

    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    payload_bytes: int = 0      # each rank's input bytes
    staged_bytes: int = 0       # bytes copied between the card and pinned host buffers
    ms: float = 0.0             # host clock inside the collectives, staging included
    # per operation (``calls``' keys): [payload bytes, staged bytes, ms,
    # result bytes (the roofline's traffic measure)]
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, payload: int, staged: int, ms: float, result: int = 0) -> None:
        self.calls[op] += 1
        self.payload_bytes += payload
        self.staged_bytes += staged
        self.ms += ms
        row = self.by_op.setdefault(op, [0, 0, 0.0, 0])
        row[0] += payload
        row[1] += staged
        row[2] += ms
        row[3] += result

    def as_dict(self) -> dict:
        return {"collective_calls": dict(self.calls), "payload_bytes": self.payload_bytes,
                "staged_bytes": self.staged_bytes, "collective_ms": self.ms,
                "by_op": {op: {"calls": self.calls[op], "payload_bytes": p,
                               "staged_bytes": s, "ms": t, "result_bytes": r}
                          for op, (p, s, t, r) in self.by_op.items()}}

    def reset(self) -> None:
        self.calls.clear()
        self.by_op.clear()
        self.payload_bytes = self.staged_bytes = 0
        self.ms = 0.0


def _raw_all_reduce(x: torch.Tensor, mesh, axis, op: str, name: str) -> torch.Tensor:
    t0 = time.perf_counter()
    nbytes = x.numel() * x.element_size()
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    staged = 0
    if x.is_meta:                   # shapes only (the dry run): nothing moves
        out = torch.empty_like(x)
    elif mesh.staged:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        dist.all_reduce(buf, op=red, group=mesh.group(axis))
        out = buf.to(x.device, non_blocking=True)
        staged = 2 * nbytes
    else:
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=red, group=mesh.group(axis))
    mesh.stats.add(name, nbytes, staged, (time.perf_counter() - t0) * 1e3, nbytes)
    return out


def _raw_all_gather(x: torch.Tensor, mesh, axis, dim: int, name: str) -> torch.Tensor:
    t0 = time.perf_counter()
    n = mesh.size(axis)
    nbytes = x.numel() * x.element_size()
    staged = 0
    if x.is_meta:
        parts = torch.empty((n, *x.shape), dtype=x.dtype, device="meta")
    elif mesh.staged:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        parts = torch.empty((n, *x.shape), dtype=x.dtype, pin_memory=True)
        dist.all_gather(list(parts.unbind(0)), buf, group=mesh.group(axis))
        parts = parts.to(x.device, non_blocking=True)
        staged = (1 + n) * nbytes
    else:
        parts = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(parts.unbind(0)), x.detach().contiguous(),
                        group=mesh.group(axis))
    out = torch.cat(parts.unbind(0), dim=dim)
    mesh.stats.add(name, nbytes, staged, (time.perf_counter() - t0) * 1e3, n * nbytes)
    return out


def _slice(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` among the ranks of ``axis``."""
    size = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.local_rank(axis) * size, size)


def _raw_reduce_scatter(x: torch.Tensor, mesh, axis, dim: int, name: str) -> torch.Tensor:
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    t0 = time.perf_counter()
    nbytes = x.numel() * x.element_size()
    # ``reduce_scatter_tensor`` splits dim 0 in rank order of the group
    front = x.detach().movedim(dim, 0)
    shape = (front.shape[0] // n, *front.shape[1:])
    staged = 0
    if x.is_meta:
        out = torch.empty(shape, dtype=x.dtype, device="meta")
    elif mesh.staged:
        buf = torch.empty(front.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(front)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, buf, group=mesh.group(axis))
        out = out.to(x.device, non_blocking=True)
        staged = nbytes + nbytes // n
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, front.contiguous(), group=mesh.group(axis))
    out = out.movedim(0, dim).contiguous()
    mesh.stats.add(name, nbytes, staged, (time.perf_counter() - t0) * 1e3, nbytes // n)
    return out


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduceSum(torch.autograd.Function):
    """*g*: the sum over the axis; backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _raw_all_reduce(x, mesh, axis, "sum", "all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    """*f*: the identity; backward the sum over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.mesh, ctx.axis, "sum", "all_reduce/bwd"), None, None


class _AllGather(torch.autograd.Function):
    """The concatenation over the axis; backward this rank's slice of the
    gradient's sum over the axis (``"reduce_scatter"``) or of the gradient
    itself (``"slice"``)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, backward):
        ctx.mesh, ctx.axis, ctx.dim, ctx.mode = mesh, axis, dim, backward
        return _raw_all_gather(x, mesh, axis, dim, "all_gather")

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "slice":
            gx = _slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous()
        else:
            gx = _raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim, "reduce_scatter/bwd")
        return gx, None, None, None, None


def all_reduce(x: torch.Tensor, mesh, axis="model", op: str = "sum") -> torch.Tensor:
    """The sum (or, ``op="max"``, the maximum) of ``x`` over the ranks of
    ``axis``, as a new tensor of ``x``'s dtype and device (``x`` is left as
    it is). Under autograd the sum's backward is the identity (*g*)."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op {op!r}; the port reduces 'sum' or 'max'")
    if _grad(x):
        if op != "sum":
            raise NotImplementedError("all_reduce(op='max') has no backward")
        return _AllReduceSum.apply(x, mesh, axis)
    return _raw_all_reduce(x, mesh, axis, op, "all_reduce" if op == "sum" else "all_reduce_max")


def copy_to_axis(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """*f* of a column-parallel block's input: ``x`` itself, whose gradient
    is summed over ``axis`` in backward. Outside autograd it is ``x``."""
    if mesh is None or mesh.size(axis) <= 1 or not _grad(x):
        return x
    return _CopyToAxis.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis="model", dim: int = -1,
               backward: str = "reduce_scatter") -> torch.Tensor:
    """The ranks' ``x`` (all of one shape) concatenated along ``dim`` in
    rank order of ``axis``, on ``x``'s device. Under autograd ``backward``
    gives ``x`` its gradient: ``"reduce_scatter"`` (this rank's slice of
    the sum over the axis) or ``"slice"`` (this rank's slice)."""
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"all_gather: backward {backward!r}")
    dim = dim % x.ndim
    if _grad(x):
        return _AllGather.apply(x, mesh, axis, dim, backward)
    return _raw_all_gather(x, mesh, axis, dim, "all_gather")


def reduce_scatter(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over the ranks of
    ``axis`` (``x.shape[dim]`` must split evenly), counted under
    ``reduce_scatter``."""
    if _grad(x):
        raise NotImplementedError("reduce_scatter: no backward (it is all_gather's)")
    return _raw_reduce_scatter(x, mesh, axis, dim % x.ndim, "reduce_scatter")


def all_gather_rows(parts: dict, mesh, axis="data") -> dict:
    """Each tensor of ``parts`` (name -> tensor; all with the same number
    of rows, dim 0, any dtypes) concatenated along dim 0 in rank order of
    ``axis``, as ONE all-gather: every row's bytes of every tensor packed
    into one uint8 message, unpacked after. Counted under ``all_gather``.
    No backward."""
    if any(_grad(t) for t in parts.values()):
        raise NotImplementedError("all_gather_rows: no backward")
    rows = {t.shape[0] for t in parts.values()}
    if len(rows) != 1:
        raise ValueError(f"all_gather_rows: the tensors' row counts differ: {sorted(rows)}")
    n = rows.pop()
    flat = [t.detach().reshape(n, -1).contiguous().view(torch.uint8) for t in parts.values()]
    got = _raw_all_gather(torch.cat(flat, dim=1), mesh, axis, 0, "all_gather")
    out, offset = {}, 0
    for (name, t), f in zip(parts.items(), flat):
        width = f.shape[1]
        out[name] = got[:, offset:offset + width].contiguous().view(t.dtype).reshape(
            (-1, *t.shape[1:]))
        offset += width
    return out
