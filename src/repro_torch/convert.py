"""Carry a reference-package parameter tree over to the port.

The reference's ``init_params`` returns a tree of arrays; converted to numpy
(``jax.tree.map(np.asarray, params)``) it goes through
:func:`params_from_numpy`, so both packages can run on the same weights.
The port itself makes its weights with ``models.model.init_params``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssd import F32_LEAVES

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Nested dict of numpy arrays -> the same tree of tensors on ``device``
    in ``cfg.dtype``: ``embed (Vp, d)`` (audio: ``(CB, Vp, d)``, and its
    ``lm_head (CB, d, Vp)``), stacked ``layers/{ln1, attn/w_q.., ln2,
    mlp/..}``, ``final_norm``; any leaf keeps its shape. Arrays of any float type (bf16 ones
    included) go through float32 on the way. The leaves the reference keeps
    in float32 whatever the model's dtype (the SSD mixer's ``ssm_A``,
    ``ssm_D``, ``ssm_dt_bias``) stay float32."""
    dt = getattr(torch, cfg.dtype)

    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)      # a writable copy
        return torch.from_numpy(arr).to(device=device,
                                         dtype=torch.float32 if name in F32_LEAVES else dt)

    return conv(tree)
