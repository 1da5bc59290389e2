"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840.
Full attention => long_500k skipped. Params ~1T total / ~32B active: one
layer's experts alone take 33.8 GB in bf16, so one card holds one layer.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi_k2_1t",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
)
