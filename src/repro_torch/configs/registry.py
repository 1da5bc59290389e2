"""Architecture registry: ``--arch <id>`` lookup + reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib

from .base import ModelConfig

# The reference zoo's ten archs, in its order.
ARCH_IDS = ["hymba_1_5b", "gemma3_27b", "granite_3_2b", "starcoder2_15b",
            "mistral_nemo_12b", "kimi_k2_1t", "dbrx_132b", "mamba2_370m",
            "musicgen_large", "pixtral_12b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_config(arch: str) -> ModelConfig:
    arch = _ALIAS.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port runs {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small dims, few layers)."""
    full = get_config(arch)
    heads = min(full.num_heads, 4)
    kv = max(1, min(full.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        full,
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=min(full.sliding_window, 32) if full.sliding_window else 0,
        global_every=full.global_every and 2,
        num_experts=min(full.num_experts, 4) or 0,
        experts_per_token=min(full.experts_per_token, 2) or 0,
        # 8-token chunks: a smoke prompt spans several; one group divides
        # any head count
        ssm_state=min(full.ssm_state, 16) or 0,
        ssm_heads=min(full.ssm_heads, 4) or 0,
        ssm_head_dim=16 if full.ssm_heads else 64,
        ssm_groups=1,
        ssm_chunk=8,
        num_patches=8,
        dtype="float32",
        remat=False,
        fsdp=False,
        falcon_mode=full.falcon_mode,
    )


def lcma_smoke_config(arch: str) -> ModelConfig:
    """Smoke config widened past the smallest LCMA tier.

    ``smoke_config`` at d_model=64 sits below every LCMA dimension tier, so
    the Decision Module always picks the classical scheme. This variant keeps
    the family and layer count but widens the projections (d_model=256,
    d_ff=512) so strassen / two-level tiers become eligible, and trims the
    vocab so logits stay cheap.
    """
    return dataclasses.replace(
        smoke_config(arch), d_model=256, d_ff=512, vocab_size=512)
