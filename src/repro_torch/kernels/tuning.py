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
           "plan_fused_gemm_quant_blocks", "TILED_TILES", "TILED_BK", "TILED_MIN_BLOCKS", "STATIC_SMEM",
           "tiled_matmul_smem", "plan_tiled_matmul_blocks", "scale_block", "block_plans"]

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
# Tile shapes csrc/tiled_matmul.cu instantiates, as (bm, bn), largest first:
# 256 threads in a 16 x 16 layout, each owning a (bm/16) x (bn/16) micro-tile.
TILED_TILES = ((128, 128), (64, 64), (16, 64))
TILED_BK = 16              # K depth of one shared-memory stage (kTBK)
TILED_MIN_BLOCKS = 128     # blocks that keep (nearly) all 132 SMs busy
STATIC_SMEM = 48 * 1024    # cap on a block's static __shared__ arrays (tiled GEMM)


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


def tiled_matmul_smem(bm: int, bn: int, bk: int = TILED_BK) -> int:
    """Shared memory of one tiled-GEMM block: one f32 stage of the A tile
    (rows padded by one word) and of the B tile."""
    return 4 * (bm * (bk + 1) + bk * bn)


def plan_tiled_matmul_blocks(M: int, N: int,
                             budget: int = SMEM_BUDGET) -> tuple[int, int, int]:
    """Tile ``(bm, bn, bk)`` of the tiled GEMM for a (M, N) output.

    Decode rows (M <= 16) take the flat 16 x 64 tile. Otherwise the largest
    tile whose grid has at least ``TILED_MIN_BLOCKS`` blocks, so a short-M
    product still spreads over the card; a problem too small for that takes
    the tile that gives it the most blocks. The kernel's tiles are static
    ``__shared__`` arrays, so ``budget`` is capped at ``STATIC_SMEM``.
    """
    budget = min(budget, STATIC_SMEM)
    fits = [(bm, bn) for bm, bn in TILED_TILES
            if tiled_matmul_smem(bm, bn) <= budget
            and fused_gemm_regs(bm, bn) <= REGS_PER_THREAD
            and fused_gemm_regs(bm, bn) * THREADS <= REGS_PER_SM]
    if not fits:
        raise ValueError(f"no tiled-GEMM tile fits {budget} bytes of shared memory")
    blocks = {t: -(-M // t[0]) * -(-N // t[1]) for t in fits}
    if M <= 16 and (16, 64) in blocks:
        tile = (16, 64)
    else:
        tile = next((t for t in fits if blocks[t] >= TILED_MIN_BLOCKS),
                    max(fits, key=lambda t: blocks[t]))
    return (*tile, TILED_BK)


def scale_block(Y: int) -> int:
    """K-block of the int8 scales for a combined K of ``Y``: the largest
    divisor of Y that is <= 128, so the blocks tile Y exactly and each int32
    sum stays far inside ``max_safe_accum_depth(32)``."""
    return next(d for d in range(min(128, Y), 0, -1) if Y % d == 0)


def block_plans(l, M: int, K: int, N: int, dtype: str = "float32",
                hw=None) -> dict:
    """Every tile the kernel pipeline picks for one LCMA application on the
    padded (M, K, N), with its shared-memory bytes, as plain data.

    The export for the autotuner (``core.autotune.calibrate`` embeds it in
    the profile's metadata) and for offline inspection. ``hw`` (a
    ``HardwareProfile``) clamps the budget to its ``vmem_bytes``, the
    per-block shared memory of the part. The kernels stage every operand as
    f32 in shared memory, so ``dtype`` is recorded but changes no tile.
    """
    budget = SMEM_BUDGET
    if hw is not None and getattr(hw, "vmem_bytes", None):
        budget = min(budget, int(hw.vmem_bytes))
    m, k, n, R = l.m, l.k, l.n, l.R
    Mp, Kp, Np = -(-M // m) * m, -(-K // k) * k, -(-N // n) * n
    X, Y, Z = Mp // m, Kp // k, Np // n
    ca = plan_combine_blocks(Y, m * k, budget)
    cb = plan_combine_blocks(Z, k * n, budget)
    fg = plan_fused_gemm_blocks(X, m, n, budget)
    by = scale_block(Y)
    qw = plan_quant_combine_warps(X, m * k, by, budget)
    fq = plan_fused_gemm_quant_blocks(X, m, n, budget)
    return {
        "grid": [m, k, n], "R": R, "dtype": str(dtype),
        "padded_shape": [Mp, Kp, Np],
        "combine_a": list(ca), "combine_b": list(cb), "fused_gemm": list(fg),
        "quant_combine_a": {"warps": qw, "by": by}, "fused_gemm_quant": list(fq),
        "combine_a_smem_bytes": combine_smem(*ca, m * k),
        "combine_b_smem_bytes": combine_smem(*cb, k * n),
        "fused_gemm_smem_bytes": fused_gemm_smem(fg[0], fg[1], m, n),
        "quant_combine_a_smem_bytes": quant_combine_smem(qw, m * k, by),
        "fused_gemm_quant_smem_bytes": fused_gemm_quant_smem(*fq, m, n),
        "smem_budget_bytes": budget,
    }
