"""Parameter trees: nested dicts whose leaves are tensors or
:class:`~repro_torch.core.engine.PlannedWeight`\\ s. A PlannedWeight's
tensors (``w``, ``bt``, ``bq``, ``b_scales``; None where absent) are
leaves of the tree, as they are children of the reference's pytree node."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import PlannedWeight

__all__ = ["tree_map", "tree_leaves"]

_PW_FIELDS = ("w", "bt", "bq", "b_scales")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, None where such a tree has no value), keeping its structure;
    None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] if r is not None else None for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, PlannedWeight):
        return dataclasses.replace(tree, **{
            f: tree_map(fn, getattr(tree, f), *(getattr(r, f) if r is not None else None
                                                for r in rest))
            for f in _PW_FIELDS})
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out
