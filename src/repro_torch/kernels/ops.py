"""The LCMA kernel pipeline: padding, the CUDA kernels, reassembly.

``falcon_matmul`` runs
  Group Combine A  ->  Group Combine B  ->  fused GEMM + Group Combine H
with all padding/unpadding handled here so the kernels see grid-divisible
operands (they mask their own ragged tile edges). ``falcon_matmul_quant``
is the int8 serving variant against offline-quantized weights; ``matmul``
is the plain tiled GEMM, the autotuner's non-LCMA control. On CPU
tensors every kernel wrapper takes its plain version, so the same pipelines
run in tests.
"""
from __future__ import annotations

import torch

from repro_torch.core.lcma import LCMA
# one padding definition shared with the rest of the dispatch core — two
# execution paths that pad differently diverge at the edges
from repro_torch.core.falcon_gemm import _pad2, _pad3
from .fused_gemm import batched_fused_gemm_combine_h, fused_gemm_combine_h, tiled_matmul
from .group_combine import batched_group_combine, group_combine
from .quant_combine import fused_gemm_combine_h_quant, group_combine_quant

__all__ = ["falcon_matmul", "falcon_matmul_precombined",
           "falcon_grouped_matmul", "falcon_grouped_matmul_precombined",
           "falcon_matmul_quant", "matmul"]


def _check_k(ap: torch.Tensor, bt: torch.Tensor, l: LCMA, K: int, what: str):
    if ap.shape[-1] // l.k != bt.shape[-2]:
        raise ValueError(
            f"{what}: activation K={K} (padded {ap.shape[-1]}, grid k={l.k}) "
            f"does not match precombined B̃ {tuple(bt.shape)} for scheme "
            f"{l.name} {l.key}")


def _reassemble(cp: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """C parts (..., m, n, X, Z) -> C (..., M, N)."""
    *lead, m, n, X, Z = cp.shape
    c = cp.transpose(-3, -2).reshape(*lead, m * X, n * Z)
    return c[..., :M, :N]


def falcon_matmul(a: torch.Tensor, b: torch.Tensor, l: LCMA) -> torch.Tensor:
    """LCMA matmul (M, K) @ (K, N) via the kernel pipeline, any shape."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"falcon_matmul: contracting dims differ: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    # The K pads of A and B coincide (both are (-K) % l.k), so the combined
    # operands stay K-consistent.
    at = group_combine(_pad2(a, l.m, l.k).contiguous(), l.U)
    bt = group_combine(_pad2(b, l.k, l.n).contiguous(), l.V)
    return _reassemble(fused_gemm_combine_h(at, bt, l.W, out_dtype=a.dtype), M, N)


def falcon_matmul_precombined(a: torch.Tensor, bt: torch.Tensor, l: LCMA,
                              n_logical: int) -> torch.Tensor:
    """Serving-path pipeline against precombined B̃ (R, K/k, N/n).

    The offline Combine-B variant of :func:`falcon_matmul`: only Group
    Combine A and the fused GEMM + Combine H run. ``bt`` comes from
    ``falcon_gemm.precombine_weights``, which is the same ``group_combine``
    with ``l.V``, so the layouts agree by construction.
    """
    M, K = a.shape
    ap = _pad2(a, l.m, l.k).contiguous()
    _check_k(ap, bt, l, K, "falcon_matmul_precombined")
    at = group_combine(ap, l.U)
    return _reassemble(fused_gemm_combine_h(at, bt, l.W, out_dtype=a.dtype),
                       M, n_logical)


def falcon_grouped_matmul(a3: torch.Tensor, b: torch.Tensor,
                          l: LCMA) -> torch.Tensor:
    """Grouped LCMA: a3 (G, M, K) x b [(K, N) | (G, K, N)] -> (G, M, N).

    Per-group Combine A (one launch), Combine B run ONCE when ``b`` is
    shared (2-D) or per group otherwise, then one grouped fused GEMM +
    Combine H over all G*R products.
    """
    G, M, K = a3.shape
    shared = b.ndim == 2
    Kb, N = b.shape[-2:]
    if K != Kb or (not shared and b.shape[0] != G):
        raise ValueError(f"falcon_grouped_matmul: shapes do not conform: "
                         f"{tuple(a3.shape)} @ {tuple(b.shape)}")
    at = batched_group_combine(_pad3(a3, l.m, l.k).contiguous(), l.U)
    if shared:
        bt = group_combine(_pad2(b, l.k, l.n).contiguous(), l.V)
    else:
        bt = batched_group_combine(_pad3(b, l.k, l.n).contiguous(), l.V)
    cp = batched_fused_gemm_combine_h(at, bt, l.W, out_dtype=a3.dtype)
    return _reassemble(cp, M, N)


def falcon_grouped_matmul_precombined(a3: torch.Tensor, bt: torch.Tensor,
                                      l: LCMA, n_logical: int) -> torch.Tensor:
    """Grouped serving pipeline against precombined B̃: (R, K/k, N/n) shared
    by the group or (G, R, K/k, N/n) per group. Combine B never runs."""
    G, M, K = a3.shape
    ap = _pad3(a3, l.m, l.k).contiguous()
    _check_k(ap, bt, l, K, "falcon_grouped_matmul_precombined")
    if bt.ndim == 4 and bt.shape[0] != G:
        raise ValueError(f"falcon_grouped_matmul_precombined: group sizes "
                         f"differ: {tuple(a3.shape)} vs B̃ {tuple(bt.shape)}")
    at = batched_group_combine(ap, l.U)
    cp = batched_fused_gemm_combine_h(at, bt, l.W, out_dtype=a3.dtype)
    return _reassemble(cp, M, n_logical)


def falcon_matmul_quant(a: torch.Tensor, bq: torch.Tensor, b_scales: torch.Tensor,
                        l: LCMA, n_logical: int) -> torch.Tensor:
    """Quantized serving pipeline against offline-quantized B̃q + scales.

    The int8 variant of :func:`falcon_matmul_precombined`: the quantizing
    Group Combine A (int8 Ã and per-(row, K-block) f32 scales in one pass
    over A), then the fused int8 GEMM + dequantizing Combine H. ``bq``
    (R, K/k, N/n) int8 and ``b_scales`` (R, (K/k)/by, N/n) come from
    ``quantize_b_blockwise``; A's scale block is forced to B's ``by`` so the
    two block-scale grids line up. C comes out in ``a``'s dtype.
    """
    M, K = a.shape
    ap = _pad2(a, l.m, l.k).contiguous()
    _check_k(ap, bq, l, K, "falcon_matmul_quant")
    by = bq.shape[-2] // b_scales.shape[-2]
    aq, a_scales = group_combine_quant(ap, l.U, by)
    cp = fused_gemm_combine_h_quant(aq, a_scales, bq, b_scales, l.W, out_dtype=a.dtype)
    return _reassemble(cp, M, n_logical)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Standard GEMM (M, K) @ (K, N) -> (M, N) in ``a``'s dtype through the
    tiled kernel, any shape (a ValueError where they do not conform). The
    counterpart of the reference's ``matmul_pallas``, without its (8, 128)
    padding: the kernel masks its ragged edges, so the result comes out
    (M, N) as it is."""
    return tiled_matmul(a.contiguous(), b.contiguous())
