"""On-chip resource planning for the Hopper kernels (paper §III-A).

Picks each kernel's block (CTA) tile from the two budgets that bind on an
H100 SM: the shared memory one block may use (232,448 bytes) and the
registers (at most 255 per thread, 65,536 per SM). The reference planner's
high-rank failure mode — an ``(R, bx, bz)`` f32 accumulator that outgrows
on-chip memory — cannot occur here: the fused kernel finishes one rank at a
time and keeps only the ``m*n`` output accumulators (see
``csrc/fused_gemm.cu``), so every scheme of the library gets a tile.
"""
from __future__ import annotations

__all__ = ["SMEM_BUDGET", "REGS_PER_THREAD", "REGS_PER_SM", "THREADS",
           "FUSED_TILES", "FUSED_BK", "QUANT_BK", "combine_smem", "plan_combine_blocks",
           "fused_gemm_smem", "fused_gemm_regs", "plan_fused_gemm_blocks",
           "quant_combine_smem", "plan_quant_combine_warps", "fused_gemm_quant_smem",
           "plan_fused_gemm_quant_blocks"]

SMEM_BUDGET = 232_448      # bytes of shared memory one block may use
REGS_PER_THREAD = 255
REGS_PER_SM = 65_536
THREADS = 256              # threads per block of both kernels

# Tile shapes csrc/fused_gemm.cu instantiates, as (bx, bz): 256 threads in a
# 16 x 16 layout, each owning a (bx/16) x (bz/16) micro-tile.
FUSED_TILES = ((64, 64), (16, 64))
FUSED_BK = 16              # K depth of one shared-memory stage (kBK)
QUANT_BK = 64              # K depth of one int8 stage of csrc/quant_combine.cu (kQBK)
QUANT_COMBINE_WARPS = 8    # most rows (one warp each) a quant-combine block holds


def combine_smem(bx: int, by: int, nparts: int) -> int:
    """Shared memory of one Group Combine block: each thread's ``nparts``
    co-located inputs, widened to f32."""
    return nparts * bx * by * 4


def plan_combine_blocks(Y: int, nparts: int, budget: int = SMEM_BUDGET) -> tuple[int, int]:
    """Block of the Group Combine kernel as ``(bx, by)`` threads, ``by``
    along the contiguous Y axis. The widest row segment that Y fills is
    taken (coalescing), with ``bx * by == THREADS``."""
    for by in (128, 64, 32):
        bx = THREADS // by
        if (by <= Y or by == 32) and combine_smem(bx, by, nparts) <= budget:
            return bx, by
    raise ValueError(f"no Group Combine block fits {nparts} parts in "
                     f"{budget} bytes of shared memory")


def fused_gemm_smem(bx: int, bz: int, m: int, n: int,
                    bk: int = FUSED_BK) -> int:
    """Shared memory of one fused block: ``m*n`` f32 output accumulator
    tiles plus one f32 stage of the At (padded) and Bt tiles."""
    return 4 * (m * n * bx * bz + bk * (bx + 1) + bk * bz)


def fused_gemm_regs(bx: int, bz: int) -> int:
    """Registers per thread, estimated: the micro-tile of H_r, one operand
    fragment of each side, and a fixed allowance for addressing."""
    tm, tn = bx // 16, bz // 16
    return tm * tn + tm + tn + 48


def _plan_fused_tile(X: int, m: int, n: int, smem, budget: int) -> tuple[int, int]:
    order = FUSED_TILES if X > 16 else FUSED_TILES[::-1]
    for bx, bz in order:
        if smem(bx, bz, m, n) > budget:
            continue
        regs = fused_gemm_regs(bx, bz)
        if regs > REGS_PER_THREAD or regs * THREADS > REGS_PER_SM:
            continue
        return bx, bz
    raise ValueError(f"no fused tile fits m*n={m * n} accumulator tiles in "
                     f"{budget} bytes of shared memory")


def plan_fused_gemm_blocks(X: int, m: int, n: int,
                           budget: int = SMEM_BUDGET) -> tuple[int, int, int]:
    """Tile ``(bx, bz, bk)`` of the fused GEMM + Combine H kernel.

    Prefers the 64 x 64 tile where it fits both budgets; a short X (decode
    rows) or a wide m*n (more than 13 accumulator tiles) takes the flat
    16 x 64 tile. The accumulator state is ``m*n`` tiles whatever R is, so
    the flat tile fits every scheme up to m*n = 55.
    """
    return (*_plan_fused_tile(X, m, n, fused_gemm_smem, budget), FUSED_BK)


def quant_combine_smem(warps: int, nparts: int, by: int) -> int:
    """Shared memory of one quant Group Combine block: per warp (one row),
    its ``nparts`` input segments of one K-block and the block's f32 sums."""
    return warps * (nparts + 1) * by * 4


def plan_quant_combine_warps(X: int, nparts: int, by: int,
                             budget: int = SMEM_BUDGET) -> int:
    """Rows (one warp each) per block of the quant Group Combine kernel:
    up to 8, no more than X, as many as fit the shared memory."""
    for warps in range(min(QUANT_COMBINE_WARPS, max(X, 1)), 0, -1):
        if quant_combine_smem(warps, nparts, by) <= budget:
            return warps
    raise ValueError(f"quant Group Combine: a K-block of {by} columns with "
                     f"{nparts} parts does not fit {budget} bytes of shared "
                     f"memory — use a smaller scale block")


def fused_gemm_quant_smem(bx: int, bz: int, m: int, n: int) -> int:
    """Shared memory of one int8 fused block: ``m*n`` f32 output accumulator
    tiles plus one int8 stage of the Aq and Bq tiles."""
    return 4 * m * n * bx * bz + QUANT_BK * (bx + bz)


def plan_fused_gemm_quant_blocks(X: int, m: int, n: int,
                                 budget: int = SMEM_BUDGET) -> tuple[int, int]:
    """Tile ``(bx, bz)`` of the int8 fused kernel: the same tiles and rule
    as :func:`plan_fused_gemm_blocks`; the K-block comes from the scales."""
    return _plan_fused_tile(X, m, n, fused_gemm_quant_smem, budget)
