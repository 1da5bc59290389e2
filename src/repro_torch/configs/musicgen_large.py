"""musicgen-large [audio]: decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32 => MHA) d_ff=8192 vocab=2048.
Backbone only, as in the reference; the EnCodec frontend is a stub — inputs are 4
parallel codebook token streams whose embeddings are summed, and the head
predicts 4 codebooks. Full attention => long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    frontend="audio_codebooks",
    num_codebooks=4,
    tie_embeddings=False,
)
