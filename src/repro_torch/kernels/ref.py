"""Plain PyTorch versions of the kernels (ground truth in tests; the CPU path).

They compute in float32 and round once to the output type, as the CUDA
kernels do. A group dimension is written out (no vmap).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lcma import LCMA

__all__ = ["group_combine_ref", "fused_gemm_combine_h_ref", "matmul_ref",
           "lcma_matmul_ref", "grouped_lcma_matmul_ref", "split_blocks"]


def _coeff(c: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(c, np.float32), device=device)


def group_combine_ref(parts: torch.Tensor, coeff: np.ndarray) -> torch.Tensor:
    """parts: (..., d1, d2, X, Y); coeff: (R, d1, d2) -> (..., R, X, Y).

    Every rank-r output tile is the coefficient-weighted sum of the
    co-located input tiles (Eq. 3/4).
    """
    c = _coeff(coeff, parts.device)
    out = torch.einsum("ril,...ilxy->...rxy", c, parts.float())
    return out.to(parts.dtype)


def fused_gemm_combine_h_ref(at: torch.Tensor, bt: torch.Tensor, w: np.ndarray,
                             out_dtype=None) -> torch.Tensor:
    """at: (..., R, X, Y); bt: (..., R, Y, Z); w: (R, m, n) -> (..., m, n, X, Z).

    H is kept in float32 and combined into C without materialization in
    the kernel (Eq. 5+6); here it is an explicit f32 tensor. ``bt`` without
    the leading group dims is shared by the group.
    """
    out_dtype = out_dtype or at.dtype
    h = torch.matmul(at.float(), bt.float())
    c = torch.einsum("rmn,...rxz->...mnxz", _coeff(w, at.device), h)
    return c.to(out_dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def split_blocks(x: torch.Tensor, d1: int, d2: int) -> torch.Tensor:
    """(..., d1*X, d2*Y) -> (..., d1, d2, X, Y)."""
    *lead, M, K = x.shape
    X, Y = M // d1, K // d2
    return x.reshape(*lead, d1, X, d2, Y).transpose(-3, -2)


def lcma_matmul_ref(a: torch.Tensor, b: torch.Tensor, l: LCMA,
                    out_dtype=None) -> torch.Tensor:
    """End-to-end: partition -> combine -> fused gemm+H -> reassemble.

    ``a`` may carry leading group dims; ``b`` is (K, N) shared or carries
    the same leading dims. Requires grid-divisible shapes.
    """
    out_dtype = out_dtype or a.dtype
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if M % l.m or K % l.k or N % l.n or b.shape[-2] != K:
        raise ValueError(f"lcma_matmul_ref({l.name}): {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} is not divisible by the grid "
                         f"<{l.m},{l.k},{l.n}> — pad first")
    at = group_combine_ref(split_blocks(a, l.m, l.k), l.U)
    bt = group_combine_ref(split_blocks(b, l.k, l.n), l.V)
    cp = fused_gemm_combine_h_ref(at, bt, l.W, out_dtype=out_dtype)
    return cp.transpose(-3, -2).reshape(*a.shape[:-2], M, N)


def grouped_lcma_matmul_ref(a3: torch.Tensor, b: torch.Tensor, l: LCMA,
                            out_dtype=None) -> torch.Tensor:
    """a3 (G, M, K) x b [(K, N) shared | (G, K, N)] -> (G, M, N).

    Per-group Combine A, a hoisted (shared b) or per-group Combine B, one
    grouped GEMM, per-group Combine H.
    """
    if a3.ndim != 3 or b.ndim not in (2, 3):
        raise ValueError(f"grouped_lcma_matmul_ref: expected (G, M, K) and "
                         f"(K, N) | (G, K, N), got {tuple(a3.shape)} @ "
                         f"{tuple(b.shape)}")
    return lcma_matmul_ref(a3, b, l, out_dtype)
