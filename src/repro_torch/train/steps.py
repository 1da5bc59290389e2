"""Step functions of the serve path: prefill and decode (inference only).

The planned backward and the training steps come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """Single-pass prefill: fills a fresh KV cache AND returns last-token
    logits. The cache lives on the tokens' device."""

    @torch.inference_mode()
    def prefill_step(params, tokens):
        cache = M.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        return M.forward(params, cfg, tokens, cache=cache, cache_index=0,
                         logits_mode="last")

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """One-token decode against a KV cache at position ``index`` (an int, or
    a (B,) tensor of per-row positions). The cache is updated in place."""

    @torch.inference_mode()
    def decode_step(params, cache, tokens, index):
        return M.forward(params, cfg, tokens, cache=cache, cache_index=index,
                         logits_mode="last")

    return decode_step
