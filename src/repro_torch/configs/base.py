"""Model configuration dataclass (the fields the decoder reads)."""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "FAMILIES"]

# The model families the port runs: all of the reference's.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
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
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # modality frontends (stubs: precomputed embeddings, as in the reference)
    frontend: str = ""              # "" | "audio_codebooks" | "vision_patches"
    num_codebooks: int = 4
    num_patches: int = 1024
    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    remat: bool = True              # activation checkpointing around each layer
    remat_policy: str = "full"      # "full"; the reference's "dots" raises here
    fsdp: bool = True               # shard params/opt-state over "data"
    # parallelism style on the fixed (data, model) mesh:
    #   "tp"        — tensor parallel over "model" (default)
    #   "fsdp_only" — no TP: batch over (data x model), params ZeRO-3 over all
    #                 axes
    parallel_style: str = "tp"
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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

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
