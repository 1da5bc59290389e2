"""hymba-1.5b [hybrid]: parallel attention+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hybrid => sub-quadratic path exists: the attention branch uses a sliding
window (global layers every 8), the SSM branch carries long context.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_every=8,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    ssm_groups=5,
    supports_long_context=True,
)
