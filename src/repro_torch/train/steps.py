"""Step functions of the serve path (inference only): one-shot prefill and
decode, and the continuous-batching engine's bucketed prefill, chunk
prefill and speculative verify. Only the one-shot prefill takes a vlm's
patch embeddings: the engine refuses the frontends, as the reference's does.

Each step writes its cache in place. The engine's steps take per-row
tensor offsets (``start``, ``index`` as (B,) tensors) and never a host
int, so that on the card a step can be captured as a CUDA graph. The
planned backward and the training steps come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

__all__ = ["make_prefill_step", "make_serve_prefill_step", "make_chunk_prefill_step",
           "make_decode_step", "make_verify_step"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """Single-pass prefill: fills a fresh KV cache AND returns last-token
    logits. The cache lives on the tokens' device. ``patch_embeds`` (B, P, d)
    is a vlm's image prefix; ``max_len`` must then count its P positions."""

    @torch.inference_mode()
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


def make_serve_prefill_step(cfg: ModelConfig, max_len: int):
    """Prefill for bucketed serving: right-padded prompts, per-row last index.

    ``last_index`` (B,) selects each request's true final prompt position
    before the LM head. K/V written at pad positions lie above each row's
    length and are overwritten before decode validity admits them; a
    per-row length mask from ``last_index`` makes the SSM/hybrid recurrent
    state exact under the right padding (dt = 0 on pad positions). Returns
    (logits (B, 1, V), cache) with the cache sized to ``max_len``.
    """

    @torch.inference_mode()
    def prefill_step(params, tokens, last_index):
        cache = M.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        hidden, cache = M.forward(params, cfg, tokens, cache=cache, cache_index=0,
                                  logits_mode="none",
                                  length_mask=_length_mask(tokens, last_index))
        return _last_logits(params, cfg, hidden, last_index), cache

    return prefill_step


def make_chunk_prefill_step(cfg: ModelConfig):
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

    @torch.inference_mode()
    def chunk_step(params, cache, tokens, start, last_index):
        if "state" in cache:
            st = cache["state"]
            st.mul_((start > 0).to(st.dtype).view((1, -1) + (1,) * (st.ndim - 2)))
        hidden, cache = M.forward(params, cfg, tokens, cache=cache, cache_index=start,
                                  logits_mode="none",
                                  length_mask=_length_mask(tokens, last_index))
        return _last_logits(params, cfg, hidden, last_index), cache

    return chunk_step


def make_decode_step(cfg: ModelConfig):
    """One-token decode against a KV cache at position ``index`` (an int, or
    a (B,) tensor of per-row positions). The cache is updated in place."""

    @torch.inference_mode()
    def decode_step(params, cache, tokens, index):
        return M.forward(params, cfg, tokens, cache=cache, cache_index=index,
                         logits_mode="last")

    return decode_step


def make_verify_step(cfg: ModelConfig):
    """Speculative verify: score γ+1 tokens in one forward, logits per row.

    ``tokens`` (B, γ+1) is ``[t_last, d_1 .. d_γ]`` per row, decoded against
    the KV cache at per-row ``index``. Causal masking makes row j's logits
    the sequential next-token distribution after ``t_last, d_1..d_j``, so
    the greedy accept rule reproduces non-speculative greedy decoding token
    for token. Returns (logits (B, γ+1, V), cache rows); rejected draft
    positions stay in the cache and are overwritten before validity admits
    them.
    """

    @torch.inference_mode()
    def verify_step(params, cache, tokens, index):
        return M.forward(params, cfg, tokens, cache=cache, cache_index=index,
                         logits_mode="all")

    return verify_step
