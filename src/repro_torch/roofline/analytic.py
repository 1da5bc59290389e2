"""Analytic per-cell cost model: FLOPs / HBM bytes / collective bytes.

The reference's model, copied: per-cell costs computed from the model
structure and the sharding, which we control exactly, beside what the dry
run traces on one rank (``launch/dryrun.py``). ``CellCosts.terms(hw)``
prices them with a port profile: on ``h100_sxm`` 989 TFLOP/s bf16, 3.35 TB/s
of HBM and 450 GB/s of NVLink (``link_bw``, data sheet).

All values are PER DEVICE. Conventions:
  * train FLOPs = fwd * (3 + 1 if remat)  (bwd = 2x fwd, remat replays fwd)
  * ring all-reduce moves 2x the tensor bytes per device; AG/RS/A2A move 1x
  * FSDP: param all-gather in fwd + bwd, gradient reduce-scatter
  * pure DP (pod axis and/or no-fsdp): gradient all-reduce (2x)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell

__all__ = ["CellCosts", "analytic_costs"]

BY = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass
class CellCosts:
    flops: float          # per device
    hbm_bytes: float      # per device
    coll_bytes: float     # per device (multipliers applied)
    detail: dict

    def terms(self, hw, dtype="bfloat16"):
        return (self.flops / hw.flops_for(dtype),
                self.hbm_bytes / hw.beta,
                self.coll_bytes / hw.link_bw)


def _layer_linear_flops(cfg: ModelConfig, T: float) -> float:
    """fwd matmul FLOPs of one layer (global, all tokens)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    f = 0.0
    if cfg.family != "ssm":
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        f += 2 * T * d * (H * hd + 2 * Hkv * hd)   # qkv
        f += 2 * T * H * hd * d                     # o
    n_mlp_mats = 2 if cfg.mlp_type == "gelu" else 3
    if cfg.family == "moe":
        f += 2 * T * d * cfg.num_experts            # router
        f += n_mlp_mats * 2 * (T * cfg.experts_per_token * cfg.capacity_factor) * d * cfg.d_ff
    elif cfg.d_ff > 0:
        f += n_mlp_mats * 2 * T * d * cfg.d_ff      # gate/up/down
    if cfg.family in ("ssm", "hybrid"):
        Hs, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
        d_in = 2 * Hs * P + 2 * G * N + Hs          # incl. z gate
        f += 2 * T * d * d_in + 2 * T * Hs * P * d  # in/out proj
    return f


def _layer_attn_flops(cfg: ModelConfig, cell: ShapeCell, decode: bool) -> float:
    """fwd attention-score+value FLOPs of one layer (global)."""
    if cfg.family == "ssm":
        return 0.0
    B, S = cell.global_batch, cell.seq_len
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    windows = cfg.layer_windows()
    n_global = sum(1 for w in windows if w == 0)
    n_local = len(windows) - n_global
    w = cfg.sliding_window or S

    def per_layer(keys_per_query):
        q = B * (1 if decode else S)
        return 2 * 2 * q * keys_per_query * H * hd  # QK^T and PV

    if decode:
        kq_g, kq_l = S, min(w, S)
    else:
        kq_g, kq_l = S / 2, min(w, S / 2)  # causal halves the average
    total = n_global * per_layer(kq_g) + n_local * per_layer(kq_l)
    return total / max(len(windows), 1)  # caller multiplies by num_layers


def _ssd_flops(cfg: ModelConfig, cell: ShapeCell, decode: bool) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    B, S = cell.global_batch, cell.seq_len
    Hs, P, N, c = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    T = B * (1 if decode else S)
    if decode:
        return 2 * T * Hs * N * P * 2               # state update + readout
    # intra: scores 2*T*c*N*H + apply 2*T*c*P*H; states/off: 2*2*T*N*P*H
    return T * Hs * (2 * c * N + 2 * c * P + 4 * N * P)


def analytic_costs(cfg: ModelConfig, cell: ShapeCell, mesh_shape: dict,
                   n_params: int, n_active: int,
                   opt_dtype: str = "float32") -> CellCosts:
    chips = int(np.prod(list(mesh_shape.values())))
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    if cfg.parallel_style == "fsdp_only":
        dp, tp = dp * tp, 1  # no TP: model axis joins the batch/ZeRO axes
    opt_by = {"float32": 4, "bfloat16": 2}[opt_dtype]
    by = BY[cfg.dtype]
    decode = cell.kind == "decode"
    B, S = cell.global_batch, cell.seq_len
    T = B * (1 if decode else S)
    Lc = cfg.num_layers
    d, V = cfg.d_model, cfg.vocab_size

    # ---------------- FLOPs ----------------
    lin = Lc * _layer_linear_flops(cfg, T)
    attn = Lc * _layer_attn_flops(cfg, cell, decode)
    ssd = Lc * _ssd_flops(cfg, cell, decode)
    ntok_logits = T if cell.kind == "train" else B
    Vp = -(-V // 256) * 256
    head = 2 * ntok_logits * d * Vp * (cfg.num_codebooks if cfg.frontend == "audio_codebooks" else 1)
    fwd = lin + attn + ssd + head
    if cell.kind != "train":
        mult = 1.0
    elif not cfg.remat:
        mult = 3.0
    elif cfg.remat_policy == "dots":
        mult = 3.15  # matmul outputs saved; only elementwise ops recomputed
    else:
        mult = 4.0
    # vocab is padded to a 256-multiple (models.model.padded_vocab) so the
    # head always shards over the full mesh.
    flops_dev = fwd / chips * mult

    # ---------------- HBM bytes ----------------
    pbytes = n_params * by
    if cell.kind == "train":
        # params: fwd read + bwd read (+ remat replay read) ; grads write+read;
        # opt m,v read+write + param write
        p_traffic = (pbytes * (3 if cfg.remat else 2) + 2 * pbytes
                     + n_params * opt_by * 4 + pbytes)
    else:
        p_traffic = pbytes * (1 if not decode else 1)
    # activations: ~6 hidden-sized tensors r/w per layer + attention score
    # traffic (flash: write+read P per chunk) + ssd chunk states
    act = 0.0
    if cell.kind != "decode":
        act += Lc * 6 * T * d * by * (3 if cell.kind == "train" else 1)
        if cfg.family != "ssm":
            # flash attention writes/reads the (qc, S)-scores per head once
            windows = cfg.layer_windows()
            for w in windows:
                keys = min(w or S, S) / (1 if w else 2)
                act += 2 * B * S * keys * cfg.num_heads * 4 / 1  # f32 scores
    kv = 0.0
    if cfg.family != "ssm" and cell.kind != "train":
        kv_tokens = B * S
        kv = 2 * Lc * kv_tokens * cfg.num_kv_heads * cfg.resolved_head_dim * by
        kv *= 2 if cell.kind == "prefill" else 1  # write on prefill, read on decode
    state = 0.0
    if cfg.family in ("ssm", "hybrid") and cell.kind != "train":
        state = 2 * Lc * B * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * by
    logits_traffic = 2 * ntok_logits * V * 4
    # params live sharded over model x (data if fsdp); each device streams its
    # own shard (replicas read their local copy, so traffic doesn't shrink
    # with replication).
    param_shards = tp * (dp if cfg.fsdp else 1)
    hbm_dev = (p_traffic / param_shards
               + (act + kv + state + logits_traffic) / chips)

    # ---------------- Collectives ----------------
    coll = 0.0
    # TP all-reduces: attn-out + mlp-out (+ssm-out) per layer, fwd (+bwd x2)
    n_ar = 0
    if cfg.family != "ssm":
        n_ar += 1
    if cfg.d_ff > 0 or cfg.family == "moe":
        n_ar += 1
    if cfg.family in ("ssm", "hybrid"):
        n_ar += 1
    # parallel_block: XLA's AllReduceReassociate merges the fwd attn+ffn ARs
    # (measured: 24 -> 22 ops on kimi); the bwd pair does NOT reassociate.
    merge_fwd = 1 if (cfg.parallel_block and n_ar >= 2) else 0
    act_bytes_dev = T * d * by / dp          # tensor local to a TP group member
    # fwd ARs (minus the parallel-block merge) + 2 per AR in bwd for training
    ar_units = (n_ar - merge_fwd) + (2 * n_ar if cell.kind == "train" else 0)
    if tp > 1:
        coll += Lc * ar_units * 2.0 * act_bytes_dev
    # logits are vocab-sharded (embed V over "model") => no (T,V) all-reduce;
    # the logsumexp cross-shard reduction is O(T) and negligible.
    if dp > 1 and cfg.fsdp:
        if cell.kind == "train":
            coll += 3.0 * pbytes / tp   # AG fwd + AG bwd + RS grads
        else:
            coll += 1.0 * pbytes / tp   # AG fwd (fsdp-sharded serving weights)
    elif cell.kind == "train" and dp > 1:
        coll += 2.0 * pbytes / tp       # ring all-reduce of grads
    if cfg.num_experts and tp > 1:
        cap_tokens = T * cfg.experts_per_token * cfg.capacity_factor
        a2a = cap_tokens * d * by / chips
        coll += Lc * 2 * a2a * (3 if cell.kind == "train" else 1)
    coll_dev = coll

    warnings = []
    if cell.kind != "decode" and B % dp != 0 and (B * S) % dp != 0:
        warnings.append(
            f"global_batch {B} (and B*S) not divisible by dp={dp}: activations "
            "replicate and these terms underestimate — wrong style for this cell")
    return CellCosts(
        flops=flops_dev, hbm_bytes=hbm_dev, coll_bytes=coll_dev,
        detail={
            "fwd_flops_global": fwd, "linear": lin, "attention": attn,
            "ssd": ssd, "head": head, "param_bytes": pbytes,
            "act_bytes_global": act, "kv_bytes_global": kv,
            "warnings": warnings,
        },
    )
