"""mamba2-370m [ssm]: SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128. d_inner = 2*d_model =
2048 => 32 SSD heads of dim 64. Attention-free: the recurrent state is
O(1) in the sequence length.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    ssm_groups=1,
    supports_long_context=True,
    tie_embeddings=True,
)
