"""Speculative decoding: a draft proposes γ tokens, one verify forward scores
them, greedy accept/rollback keeps output token-exact.

Why this is cheap here: serving already amortizes Decision-Module plans
over a closed pow2 bucket grid, so draft steps and the ``(batch, γ+1)``
verify forward are *just more buckets*: ``warm_buckets(spec_gamma=γ)``
pre-plans them (the only new registry symbol is ``logit_tokens = B·(γ+1)``,
since the lm head scores every verify row), and a layer-sliced self-draft
shares the target's per-layer contraction shapes, so speculation adds no
plan-cache keys beyond the two extra bucket contexts. On the card each of
the draft's steps is one more captured graph.

Greedy accept rule (:meth:`~repro_torch.serve.engine.ServeEngine` verify
round): feed ``[t_last, d_1..d_γ]`` through one cached forward, take per-row
argmax ``t'_0..t'_γ``, accept the longest prefix with ``d_j == t'_{j-1}``,
emit ``t'_0..t'_{n_acc}`` (the bonus token makes every round emit ≥ 1). By
induction each emitted token equals what sequential greedy decode would
have produced, so exactness never depends on draft quality: the acceptance
rate only sets the speedup. Rollback is free for attention KV: decode
validity admits ``kpos < pos + S`` and every position is rewritten before it
first becomes visible, so rejected draft K/V is never observed.

The draft keeps its own slot KV consistent with a fixed-shape *catch-up*
trick: every round starts with one ``(B, 2)`` forward feeding ``[t_prev,
t_last]`` at ``pos-1`` (re-writing an already-cached position is
idempotent: same prefix, same K/V), which repairs the draft cache for any
acceptance count of the previous round, with uniform warmed shapes. Each
proposal feeds the next ``(B, 1)`` step on the device; the γ proposals come
back to the host in one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.train.steps import make_chunk_prefill_step, make_decode_step

from .prefix_cache import check_kv_cache
from .step_graphs import StepGraphs, rows_step, slot_index

__all__ = ["DraftModel", "SelfDraft"]


@runtime_checkable
class DraftModel(Protocol):
    """What the engine needs from a draft: propose tokens, mirror prefill.

    A draft owns its own per-slot cache and stays position-synchronized
    with the target through these calls; any model with the same tokenizer
    can implement it. :class:`SelfDraft` is the reference implementation.
    """

    def prefill_chunk(self, tokens, start, last, slots, k) -> None:
        """Mirror one (padded) prefill chunk into the draft's slot cache."""
        ...

    def propose(self, slot_idx, last2, pos, gamma: int, k: int) -> np.ndarray:
        """γ greedy draft tokens per row -> (B, γ) int array."""
        ...

    def snapshot(self, slot: int, length: int) -> Any:
        """Opaque per-slot prefix payload for the radix prefix cache."""
        ...

    def load(self, slot: int, payload: Any, length: int) -> None:
        """Restore a :meth:`snapshot` payload into ``slot``."""
        ...

    def warm(self, policy, gamma: int) -> int:
        """Prepare every step shape; returns the number of shapes."""
        ...


class SelfDraft:
    """Layer-sliced self-draft: the target's first ``keep_layers`` layers.

    Built from the *raw* (pre-precombine) target params: the stacked
    ``params["layers"]`` tree is sliced ``[:keep]`` and the embedding and
    final norm are shared, under ``dataclasses.replace(cfg,
    num_layers=keep)``. Same widths, so identical per-layer contraction
    shapes: the draft hits the target's warmed plan-cache keys.

    ``keep_layers=None`` keeps every layer: the *identity draft*, whose
    proposals match the target's greedy choice (acceptance ≈ 1.0), the
    default for runs on random weights, where a truncated stack predicts
    noise. Its slot cache has one spare row past ``max_slots`` that pad rows
    write (:func:`slot_index`). ``graphs`` is the engine's
    :class:`StepGraphs`, so the draft's steps share its graph pool.
    """

    def __init__(self, model_cfg, params, *, max_slots: int, max_len: int,
                 keep_layers: int | None = None, graphs: StepGraphs | None = None):
        keep = int(keep_layers or model_cfg.num_layers)
        if not 1 <= keep <= model_cfg.num_layers:
            raise ValueError(f"keep_layers={keep} out of range 1..{model_cfg.num_layers}")
        self.cfg = dataclasses.replace(model_cfg, num_layers=keep)
        self.keep_layers = keep
        if keep == model_cfg.num_layers:
            self.params = params            # identity draft shares the tree
        else:
            self.params = dict(params)
            self.params["layers"] = _slice_layers(params["layers"], keep)
        device = params["embed"].device
        self.graphs = graphs or StepGraphs(device, enabled=False)
        self.max_len = max_len
        self.spare = max_slots
        self.cache = M.init_cache(self.cfg, max_slots + 1, max_len, device=device)
        self._chunk_fn = make_chunk_prefill_step(self.cfg)
        self._decode_fn = make_decode_step(self.cfg)

    def _step(self, key: tuple):
        """The draft's step of ``key``: ("draft_prefill", B, S), or the
        ("draft_catchup", b) and ("draft_step", b) decode forwards."""
        def make():
            b, prefill = key[1], key[0] == "draft_prefill"
            width = key[2] if prefill else {"draft_catchup": 2, "draft_step": 1}[key[0]]
            inputs = {"tokens": (b, width), "index": (b,), "gidx": (b,), "sidx": (b,)}
            if prefill:
                inputs["last"] = (b,)
            fn = rows_step(self._chunk_fn if prefill else self._decode_fn, self.params,
                           self.cache)
            return fn, inputs, {"gidx": self.spare, "sidx": self.spare}
        return self.graphs.get(key, make)

    # -- prefill mirror ------------------------------------------------------

    def prefill_chunk(self, tokens, start, last, slots, k) -> None:
        B, S = tokens.shape
        gidx, sidx = slot_index(slots[:k], B, self.spare)
        step = self._step(("draft_prefill", B, S))
        step.load(tokens=tokens, index=start, last=last, gidx=gidx, sidx=sidx)
        step()

    # -- drafting ------------------------------------------------------------

    def propose(self, slot_idx, last2, pos, gamma: int, k: int) -> np.ndarray:
        """Catch-up ``(B, 2)`` forward, then γ-1 single-token greedy steps,
        each fed the previous proposal on the device."""
        slot_idx = np.asarray(slot_idx, np.int64)
        b = len(slot_idx)
        _, sidx = slot_index(slot_idx[:k], b, self.spare)
        catch = self._step(("draft_catchup", b))
        # catch-up: re-feed [t_prev, t_last] at pos-1; rewriting the cached
        # position pos-1 is idempotent, and this repairs the draft KV after
        # any acceptance count of the previous round with one fixed shape
        catch.load(tokens=last2, index=np.asarray(pos) - 1, gidx=slot_idx, sidx=sidx)
        greedy, _ = catch()
        drafts = torch.empty((b, gamma), dtype=torch.long, device=self.cache["k"].device)
        drafts[:, 0] = greedy[:, -1]
        if gamma > 1:
            one = self._step(("draft_step", b))
            for name in ("gidx", "sidx"):
                one.inputs[name].copy_(catch.inputs[name])
            one.inputs["index"].copy_(catch.inputs["index"] + 2)
            for j in range(1, gamma):
                one.inputs["tokens"].copy_(drafts[:, j - 1:j])
                greedy, _ = one()
                drafts[:, j] = greedy[:, -1]
                one.inputs["index"].add_(1)
        return drafts.cpu().numpy()

    # -- prefix-cache payloads ----------------------------------------------

    def snapshot(self, slot: int, length: int) -> Any:
        return {name: c[:, slot, :length].clone()
                for name, c in check_kv_cache(self.cache).items()}

    def load(self, slot: int, payload: Any, length: int) -> None:
        for name, c in check_kv_cache(self.cache).items():
            c[:, slot, :length].copy_(payload[name])

    # -- warmup --------------------------------------------------------------

    def warm(self, policy, gamma: int) -> int:
        """Prepare the draft's chunk-prefill, catch-up and single-token
        steps, so no live round pays a first run or a capture."""
        keys = [("draft_prefill", b, s) for b, s in policy.prefill_shapes()]
        keys += [("draft_catchup", b) for b in policy.decode_batch]
        if gamma > 1:
            keys += [("draft_step", b) for b in policy.decode_batch]
        for key in keys:
            self._step(key)
        return len(keys)


def _slice_layers(stacked, keep: int):
    if isinstance(stacked, dict):
        return {k: _slice_layers(v, keep) for k, v in stacked.items()}
    return stacked[:keep]
