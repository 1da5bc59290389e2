"""dbrx-132b [moe]: 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352.
Full attention => long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
)
