"""Model configuration dataclass (the fields the dense decoder reads)."""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # the port runs "dense" only
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    mlp_type: str = "swiglu"        # "swiglu" (3-matrix) | "gelu" (2-matrix)
    # attention pattern
    sliding_window: int = 0         # 0 => full attention
    global_every: int = 0           # one global layer every N (rest local)
    rope_theta: float = 1e4
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # PaLM-style parallel attention+FFN block: both branches read ln1(x)
    parallel_block: bool = False
    # FalconGEMM integration
    use_falcon: bool = True
    falcon_mode: str = "auto"       # "auto" | "gemm" | scheme name
    falcon_backend: str = "cuda"    # the reference's default is "jnp"
    # long-context applicability (a sub-quadratic attention path exists)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def layer_windows(self) -> list[int]:
        """Per-layer sliding window (0 = global/full attention)."""
        if self.sliding_window == 0:
            return [0] * self.num_layers
        if self.global_every <= 0:
            return [self.sliding_window] * self.num_layers
        return [
            0 if (i + 1) % self.global_every == 0 else self.sliding_window
            for i in range(self.num_layers)
        ]
