"""pixtral-12b [vlm]: pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The ViT frontend is
a stub, as in the reference: precomputed patch embeddings (B, num_patches,
d_model) are prepended to the text tokens (the launcher draws them from its
seed); a sequence counts text + patches. Full attention => long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="vision_patches",
    num_patches=1024,
)
