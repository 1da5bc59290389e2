"""The collectives of tensor- and expert-parallel serving, over a mesh axis.

``all_reduce`` sums a partial result (a row-parallel projection, the
vocab-sharded embedding, the expert-parallel MoE output) and
``all_gather`` concatenates shards (the LM head's vocab shards, the MoE
router's logits), each over the process group of one axis of a
:class:`~repro_torch.parallel.mesh.Mesh`. On a gloo mesh a CUDA tensor
crosses through a pinned host buffer: ``torch.distributed`` documents only
``broadcast`` and ``all_reduce`` as gloo's CUDA operations (torch 2.11's
gloo also gathers CUDA tensors), and gloo's CUDA path copies through host
memory itself, so one staged path serves both operations on every version
and its bytes are counted. A collective that fails raises; nothing retries
on another backend.

Each mesh counts its collectives (:class:`CollectiveStats`): calls by
operation, payload and staged bytes, and milliseconds on the host clock
(the staged copies included; a gloo collective returns when it is done, an
nccl one when it is queued).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch
import torch.distributed as dist

__all__ = ["CollectiveStats", "all_reduce", "all_gather"]


@dataclasses.dataclass
class CollectiveStats:
    """Counters of one mesh's collectives since it was made (or ``reset``)."""

    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    payload_bytes: int = 0      # each rank's input bytes
    staged_bytes: int = 0       # bytes copied between the card and pinned host buffers
    ms: float = 0.0             # host clock inside the collectives, staging included

    def as_dict(self) -> dict:
        return {"collective_calls": dict(self.calls), "payload_bytes": self.payload_bytes,
                "staged_bytes": self.staged_bytes, "collective_ms": self.ms}

    def reset(self) -> None:
        self.calls.clear()
        self.payload_bytes = self.staged_bytes = 0
        self.ms = 0.0


def _check(x: torch.Tensor, op: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{op}: the collectives have no backward; tensor-parallel training comes with "
            "the training half of multi-device (ROADMAP Queue 1 item 6b)")


def all_reduce(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, as a new tensor of
    ``x``'s dtype and device (``x`` is left as it is)."""
    _check(x, "all_reduce")
    t0 = time.perf_counter()
    nbytes = x.numel() * x.element_size()
    if mesh.staged:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        dist.all_reduce(buf, group=mesh.group(axis))
        out = buf.to(x.device, non_blocking=True)
        mesh.stats.staged_bytes += 2 * nbytes
    else:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group(axis))
    mesh.stats.calls["all_reduce"] += 1
    mesh.stats.payload_bytes += nbytes
    mesh.stats.ms += (time.perf_counter() - t0) * 1e3
    return out


def all_gather(x: torch.Tensor, mesh, axis: str = "model", dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` (all of one shape) concatenated along ``dim`` in
    rank order of ``axis``, on ``x``'s device."""
    _check(x, "all_gather")
    t0 = time.perf_counter()
    n = mesh.size(axis)
    nbytes = x.numel() * x.element_size()
    if mesh.staged:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        parts = torch.empty((n, *x.shape), dtype=x.dtype, pin_memory=True)
        dist.all_gather(list(parts.unbind(0)), buf, group=mesh.group(axis))
        parts = parts.to(x.device, non_blocking=True)
        mesh.stats.staged_bytes += (1 + n) * nbytes
    else:
        parts = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(parts.unbind(0)), x.contiguous(), group=mesh.group(axis))
    out = torch.cat(parts.unbind(0), dim=dim)
    mesh.stats.calls["all_gather"] += 1
    mesh.stats.payload_bytes += nbytes
    mesh.stats.ms += (time.perf_counter() - t0) * 1e3
    return out
