"""LR schedules (scale factors applied on top of ``AdamWConfig.lr``)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1, then a cosine down to ``min_ratio`` at
    ``total_steps``: a float32 scalar tensor (on ``step``'s device where
    ``step`` is a tensor), computed as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
