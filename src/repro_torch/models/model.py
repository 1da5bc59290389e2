"""Decoder LM, dense family (granite): init, KV cache, forward, logits.

Params are a nested dict of tensors with the reference's layout: ``embed``
(Vp, d), ``layers`` holding every per-layer leaf stacked on a leading layer
dim, ``final_norm``. The layer stack is a Python loop over slices of it. All
projections, the tied LM head and the attention contractions are
FalconGEMM-dispatched.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine
from repro_torch.core.falcon_gemm import FalconConfig
from . import layers as L

__all__ = ["init_params", "forward", "init_cache", "falcon_config_for",
           "compute_logits", "padded_vocab", "layer_params"]


def falcon_config_for(cfg: ModelConfig) -> FalconConfig:
    """The FalconGEMM policy for this model (one device: no shard scaling)."""
    return FalconConfig(enabled=cfg.use_falcon, mode=cfg.falcon_mode,
                        backend=cfg.falcon_backend)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the port runs the dense family "
                                  f"only (got family={cfg.family!r})")


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (granite's 49155 -> 49408)."""
    return -(-cfg.vocab_size // 256) * 256


# Embedding rows drawn per float32 block of ``init_params``.
_EMBED_ROWS = 8192


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Random weights at the config's widths, made on ``device`` from a
    seeded generator (not the reference's numbers: the RNGs differ). Each
    leaf is allocated in the config's dtype and drawn in float32 pieces of
    at most one layer slice (the embedding: ``_EMBED_ROWS`` rows), so the
    largest transient is one slice, not a whole stacked leaf."""
    _check_family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    Lc, d = cfg.num_layers, cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Vp = padded_vocab(cfg)
    ones = lambda *s: torch.ones(s, dtype=dt, device=device)  # noqa: E731
    dense = lambda *s: L.dense_init(gen, s, dt, device)        # noqa: E731
    layers = {
        "ln1": ones(Lc, d),
        "attn": {"w_q": dense(Lc, d, H * hd), "w_k": dense(Lc, d, Hkv * hd),
                 "w_v": dense(Lc, d, Hkv * hd), "w_o": dense(Lc, H * hd, d)},
        "ln2": ones(Lc, d),
    }
    if cfg.mlp_type == "gelu":
        layers["mlp"] = {"mlp_up": dense(Lc, d, cfg.d_ff),
                         "mlp_down": dense(Lc, cfg.d_ff, d)}
    else:
        layers["mlp"] = {"mlp_gate": dense(Lc, d, cfg.d_ff),
                         "mlp_up": dense(Lc, d, cfg.d_ff),
                         "mlp_down": dense(Lc, cfg.d_ff, d)}
    params = {
        # in blocks of rows: gemma3's f32 embedding alone would be 5.6 GB
        "embed": L.normal_init(gen, (Vp, d), lambda w: w * 0.02, dt, device,
                               rows=_EMBED_ROWS),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, Vp)
    return params


def layer_params(stacked, i: int):
    """Slice layer ``i`` out of the stacked per-layer tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               dtype=None) -> dict:
    dt = getattr(torch, dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _layer(x, lp, window: int, cfg: ModelConfig, positions, cache_layer=None,
           cache_index=None):
    dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, _ = L.attn_apply(lp["attn"], h, dims, positions, cfg.rope_theta, window,
                        cache=cache_layer, cache_index=cache_index)
    x = x + y
    h2 = h if cfg.parallel_block else L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h2)


def forward(params, cfg: ModelConfig, tokens, *, cache=None, cache_index=None,
            logits_mode: str = "none"):
    """Run the decoder stack on ``tokens`` (B, S).

    logits_mode: "none" (return hidden), "last" (logits of the final
    position), "all". With a ``cache`` the new K/V are written into it in
    place at ``cache_index``. Returns (out, cache). FalconGEMM policy is the
    ambient config, else this model's ``falcon_config_for``.
    """
    _check_family(cfg)
    with engine.config_scope(lambda: falcon_config_for(cfg)):
        x = params["embed"][tokens]                             # (B, S, d)
        B, S = tokens.shape
        steps = torch.arange(S, device=tokens.device)
        if cache is None:
            positions = steps.expand(B, S)
        elif isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            positions = cache_index[:, None] + steps            # per-row offsets
        else:
            positions = (int(cache_index) + steps).expand(B, S)
        for i, window in enumerate(cfg.layer_windows()):
            cl = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
            x = _layer(x, layer_params(params["layers"], i), window, cfg,
                       positions, cache_layer=cl, cache_index=cache_index)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if logits_mode == "none":
            return x, cache
        if logits_mode == "last":
            x = x[:, -1:]
        return compute_logits(params, cfg, x), cache


def compute_logits(params, cfg: ModelConfig, x):
    """LM head (tied to the embedding unless ``lm_head`` exists), with the
    padded-vocab columns masked to -1e30."""
    with engine.config_scope(lambda: falcon_config_for(cfg)):
        w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
        logits = engine.dense(x, w)
        Vp = padded_vocab(cfg)
        if Vp == cfg.vocab_size:
            return logits
        pad_mask = torch.arange(Vp, device=x.device) < cfg.vocab_size
        return torch.where(pad_mask, logits, -1e30)
