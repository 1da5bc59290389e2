"""starcoder2-15b [dense]: GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. Full attention =>
long_500k skipped. d_ff=24576 makes its MLP the best LCMA target in the pool.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
)
