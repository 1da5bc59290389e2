"""Compressed data-parallel gradient all-reduce (distributed-optimization trick).

int8 quantization with a shared per-leaf scale: each DP rank quantizes its
local gradient to int8 against the global max (the leaves' maxima travel
as one vector in one max all-reduce), the int8 payload is summed in int32
(the leaves' payloads concatenated into buckets of at most
``BUCKET_BYTES``, one sum each), and the mean is dequantized. The
reference's arithmetic (``src/repro/parallel/compression.py``) exactly:

    scale = max(all_reduce_max(max |g32|), 1e-20)
    q     = clip(round(g32 / scale * levels), -levels, levels)   as int8
    total = all_reduce_sum(q as int32)
    mean  = (total.float() * (scale / levels) / n).to(g.dtype)

``torch.round`` rounds half to even, as ``jnp.round`` does. The reference
runs it inside ``shard_map`` over the DP axes; the port's ranks call it on
their local gradients over the mesh's axes
(``train.steps.make_compressed_dp_train_step``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

from .collectives import all_reduce

__all__ = ["compressed_psum_mean", "psum_mean", "BUCKET_BYTES"]

BUCKET_BYTES = 256 << 20     # int32 bytes summed in one collective, at most


def psum_mean(tree, mesh, axes=("data",)):
    """The exact mean of every leaf of ``tree`` over the ranks of ``axes``."""
    n = mesh.size(tuple(axes))
    return tree_map(lambda g: all_reduce(g, mesh, tuple(axes)) / n, tree)


def compressed_psum_mean(tree, mesh, axes=("data",), bits: int = 8):
    """Mean-all-reduce every leaf of ``tree`` over the ranks of ``axes``
    with int``bits`` compression, each leaf against its own scale."""
    axes = tuple(axes)
    n = mesh.size(axes)
    levels = float(2 ** (bits - 1) - 1)
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    scales = all_reduce(torch.stack([torch.max(torch.abs(g.float())) for g in leaves]),
                        mesh, axes, op="max")
    scales = torch.clamp(scales, min=1e-20)
    # each leaf's flat int32 payload in pieces of at most a bucket, the
    # pieces summed a bucket at a time; q is made piece by piece, so the
    # int32 copy of the whole tree never exists
    cap = BUCKET_BYTES // 4
    pieces = [(i, lo, min(lo + cap, g.numel())) for i, g in enumerate(leaves)
              for lo in range(0, g.numel(), cap)]
    sums: list[list[torch.Tensor]] = [[] for _ in leaves]
    bucket: list[tuple[int, int, int]] = []

    def flush():
        qs = []
        for i, lo, hi in bucket:
            g = leaves[i].reshape(-1)[lo:hi].float()
            qs.append(torch.clamp(torch.round(g / scales[i] * levels), -levels, levels)
                      .to(torch.int8).to(torch.int32))
        red = all_reduce(torch.cat(qs), mesh, axes)
        for (i, lo, hi), t in zip(bucket, red.split([hi - lo for _, lo, hi in bucket])):
            sums[i].append(t)
        bucket.clear()

    for piece in pieces:
        if bucket and sum(hi - lo for _, lo, hi in bucket) + piece[2] - piece[1] > cap:
            flush()
        bucket.append(piece)
    if bucket:
        flush()
    out = iter([(torch.cat(t).float() * (scales[i] / levels) / n).to(g.dtype).view(g.shape)
                for i, (t, g) in enumerate(zip(sums, leaves))])
    return tree_map(lambda _: next(out), tree)
