"""Plain PyTorch versions of the kernels (ground truth in tests; the CPU path).

They compute in float32 and round once to the output type, as the CUDA
kernels do. A group dimension is written out (no vmap).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lcma import LCMA

__all__ = ["group_combine_ref", "fused_gemm_combine_h_ref", "tiled_matmul_ref",
           "lcma_matmul_ref", "grouped_lcma_matmul_ref", "split_blocks",
           "group_combine_quant_ref", "fused_gemm_combine_h_quant_ref",
           "quantize_blocks_ref", "quantize_b_blockwise_ref"]


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


def tiled_matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(M, K) @ (K, N): the f32 product of the upcast operands, cast once."""
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


# ---------------------------------------------------------------------------
# int8 tier. The reference's quantized kernels fix the order of every f32
# operation; these versions keep it, so the CUDA kernels, which keep it too,
# agree with both bit for bit on the same inputs.
# ---------------------------------------------------------------------------

_INV127 = float(np.float32(1) / np.float32(127))   # f32(1/127), exact as a float


def _signed_sum(terms) -> torch.Tensor | None:
    """Sum ``(c, t)`` in the given order as the reference's kernels do:
    ``t``, ``-t`` or ``t * c``, the first term taken as is, then added."""
    acc = None
    for c, t in terms:
        c = int(c)
        if c == 0:
            continue
        t = t if c == 1 else (-t if c == -1 else t * c)
        acc = t if acc is None else acc + t
    return acc


def _quantize(acc: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 127-level quantization with one scale per slice along
    ``dim``: ``s = max(amax / 127, 1e-12)``, ``q = clip(round(acc / s))``,
    rounding half to even.

    ``amax / 127`` is taken as ``amax * f32(1/127)``: XLA rewrites a division
    by a constant into a product with its rounded reciprocal, so that is what
    the reference computes (one ulp from the true quotient at times, enough
    to move a ``q`` on a rounding boundary). ``acc / s`` is a true division
    there and here."""
    s = torch.clamp_min(acc.abs().amax(dim=dim, keepdim=True) * _INV127, 1e-12)
    q = torch.clamp(torch.round(acc / s), -127, 127).to(torch.int8)
    return q, s


def group_combine_quant_ref(x: torch.Tensor, coeff: np.ndarray,
                            by: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (d1*X, d2*Y) -> (q int8 (R, X, Y), scales f32 (R, X, Y/by)).

    Combine A in f32 over the nonzero terms in ascending (i, l) order, then
    one scale per (rank, row, K-block of ``by`` columns).
    """
    R, d1, d2 = coeff.shape
    parts = split_blocks(x, d1, d2)
    X, Y = parts.shape[-2:]
    if Y % by:
        raise ValueError(f"group_combine_quant_ref: K-block {by} does not divide Y={Y}")
    qs, ss = [], []
    for r in range(R):
        acc = _signed_sum((coeff[r, i, l], parts[i, l].float())
                          for i in range(d1) for l in range(d2))
        if acc is None:
            acc = torch.zeros((X, Y), dtype=torch.float32, device=x.device)
        q, s = _quantize(acc.reshape(X, Y // by, by), dim=2)
        qs.append(q.reshape(X, Y))
        ss.append(s[..., 0])
    return torch.stack(qs), torch.stack(ss)


def fused_gemm_combine_h_quant_ref(aq: torch.Tensor, a_scales: torch.Tensor,
                                   bq: torch.Tensor, b_scales: torch.Tensor,
                                   w: np.ndarray, out_dtype=torch.float32
                                   ) -> torch.Tensor:
    """aq (R, X, Y) int8, a_scales (R, X, Yb), bq (R, Y, Z) int8, b_scales
    (R, Yb, Z); w (R, m, n) -> (m, n, X, Z) in ``out_dtype``.

    H_r sums ``(int-product * a_scale) * b_scale`` over the K-blocks in
    ascending order, then Combine H runs in ascending r. The int-product is
    an f32 matmul of the int8 values, exact while every partial sum stays
    below 2**24 (by <= 128: at most 128 * 127**2) and TF32 is off.
    """
    R, m, n = w.shape
    _, X, Y = aq.shape
    Yb = a_scales.shape[-1]
    by = Y // Yb
    # every rank's K-block product at once (a batched matmul over R: the
    # int8 products and their sums are exact in f32), accumulated over the
    # K-blocks in ascending order as above
    h = None
    for y in range(Yb):
        part = torch.matmul(aq[:, :, y * by:(y + 1) * by].float(),
                            bq[:, y * by:(y + 1) * by].float())
        t = part * a_scales[:, :, y:y + 1] * b_scales[:, y:y + 1]
        h = t if h is None else h + t
    out = torch.empty((m, n, X, bq.shape[-1]), dtype=out_dtype, device=aq.device)
    for i in range(m):
        for j in range(n):
            acc = _signed_sum((w[r, i, j], h[r]) for r in range(R))
            out[i, j] = 0 if acc is None else acc.to(out_dtype)
    return out


def quantize_blocks_ref(bt: torch.Tensor, by: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Combined weight (R, Y, Z) -> (bq int8 (R, Y, Z), scales f32
    (R, Y/by, Z)): one scale per (rank, K-block, column)."""
    R, Y, Z = bt.shape
    if Y % by:
        raise ValueError(f"quantize_blocks_ref: K-block {by} does not divide Y={Y}")
    q, s = _quantize(bt.float().reshape(R, Y // by, by, Z), dim=2)
    return q.reshape(R, Y, Z), s[:, :, 0]


def quantize_b_blockwise_ref(b: torch.Tensor, coeff: np.ndarray,
                             by: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline Combine B of a static weight (K, N), in the weight's dtype,
    then blockwise int8 quantization (:func:`quantize_blocks_ref`)."""
    R, d1, d2 = coeff.shape
    return quantize_blocks_ref(group_combine_ref(split_blocks(b, d1, d2), coeff), by)
