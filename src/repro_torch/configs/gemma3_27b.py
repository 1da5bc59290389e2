"""gemma3-27b [dense]: 5:1 local:global attention, 128k ctx [hf:google/gemma-3].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5 sliding-window layers per 1 global layer => effectively sub-quadratic for
long context (global layers dominate asymptotically but are 1/6 of depth);
the reference's long_500k shape cell runs for this arch.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    rope_theta=1e6,
    supports_long_context=True,
)
