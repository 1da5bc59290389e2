"""On-chip resource planning for the Hopper kernels (paper §III-A).

Picks each kernel's block (CTA) tile from the two budgets that bind on an
H100 SM: the shared memory one block may use (232,448 bytes) and the
registers (at most 255 per thread, 65,536 per SM). The reference planner's
high-rank failure mode — an ``(R, bx, bz)`` f32 accumulator that outgrows
on-chip memory — cannot occur here: the fused kernels finish one rank at a
time and keep only the ``m*n`` output accumulators (see
``csrc/fused_tc.cuh``), so every scheme of the library gets a tile.

The tensor-core fused kernels (bf16 and int8) also get a split count S:
where the output tiles alone leave the card idle (decode rows), the
flattened (rank, K-chunk) reduction is cut into S contiguous ranges, one
block each, and a second pass sums the S f32 partials in fixed order.
"""
from __future__ import annotations

import functools
from dataclasses import asdict, dataclass

__all__ = ["SMEM_BUDGET", "REGS_PER_THREAD", "REGS_PER_SM", "THREADS", "SMS",
           "FUSED_TILES", "FUSED_BK", "combine_smem", "plan_combine_blocks",
           "fused_gemm_smem", "fused_gemm_regs", "plan_fused_gemm_blocks",
           "TC_THREADS", "TC_TILES", "TC_WARPS", "TC_BK", "TC_STAGES", "TC_ACC_REGS",
           "SPLIT_MIN_BLOCKS", "FusedPlan", "fused_tc_smem", "fused_tc_regs",
           "plan_fused_tc", "split_ranges",
           "quant_combine_smem", "plan_quant_combine_warps",
           "TILED_TILES", "TILED_BK", "TILED_MIN_BLOCKS", "STATIC_SMEM",
           "tiled_matmul_smem", "plan_tiled_matmul_blocks", "scale_block", "block_plans"]

SMEM_BUDGET = 232_448      # bytes of shared memory one block may use
REGS_PER_THREAD = 255
REGS_PER_SM = 65_536
THREADS = 256              # threads per block of the SIMT kernels
SMS = 132                  # streaming multiprocessors of an H100 SXM

# Tile shapes the f32 SIMT kernel of csrc/fused_gemm.cu instantiates, as
# (bx, bz): 256 threads in a 16 x 16 layout, each owning a (bx/16) x (bz/16)
# micro-tile.
FUSED_TILES = ((64, 64), (16, 64))
FUSED_BK = 16              # K depth of one shared-memory stage (kBK)

# The tensor-core fused kernels (csrc/fused_tc.cuh, bf16 and int8): 4 warps;
# a block owns a bz x bx tile of H^T (z on the MMA's 16-row side, the rows x
# of A on its 8-wide side), the warps laid out warps_z x warps_x.
TC_THREADS = 128
TC_TILES = ((32, 64), (16, 64), (8, 64))     # (bx, bz), widest first
TC_WARPS = {(32, 64): (2, 2), (16, 64): (4, 1), (8, 64): (4, 1)}
TC_BK = 128                # K elements of one ring stage (both dtypes)
TC_STAGES = 3              # depth of the cp.async ring
TC_PAD = 16                # bytes after every staged row (ldmatrix without bank conflicts)
TC_ACC_REGS = 4            # m*n up to this: output accumulators in registers
SPLIT_MIN_BLOCKS = 2 * SMS  # blocks a split grid aims for
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


@functools.lru_cache(maxsize=4096)
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


@dataclass(frozen=True)
class FusedPlan:
    """One launch of a tensor-core fused kernel.

    ``bx`` x ``bz`` is the output tile (rows of A x columns of B); the
    reduction over (rank, K) is a sequence of ``units`` units of
    ``steps_per_unit`` ring stages of ``bk`` K elements each (bf16: one
    stage per unit; int8: one unit per K-block of ``by`` columns, so a split
    never cuts an int32 sum). ``splits`` contiguous unit ranges
    (:func:`split_ranges`) go to as many blocks per tile, at most
    ``split_max``; ``splits > 1`` needs a (splits, G, m*n, X, Z) f32
    workspace.
    """
    bx: int
    bz: int
    bk: int
    stages: int
    splits: int
    units: int
    steps_per_unit: int
    acc_in_regs: bool
    smem_bytes: int
    tiles: int
    split_max: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def as_dict(self) -> dict:
        return {**asdict(self), "blocks": self.blocks}


def _row(n: int, itemsize: int) -> int:
    """Bytes of one staged row of ``n`` elements, padded."""
    return n * itemsize + TC_PAD


def fused_tc_smem(bx: int, bz: int, mn: int, quant: bool) -> int:
    """Shared memory of one tensor-core fused block: the ring (an At tile
    [bx][bk] and a Bt tile [bk][bz] per stage, and for int8 the f32 row and
    column scales of the stage's K-block), for int8 the transposed Bq tile
    [bz][bk] the MMA reads, and the m*n f32 output accumulators where they
    do not stay in registers."""
    isz = 1 if quant else 2
    total = TC_STAGES * (bx * _row(TC_BK, isz) + TC_BK * _row(bz, isz))
    if quant:
        total += TC_STAGES * 4 * (bx + bz) + bz * _row(TC_BK, 1)
    if mn > TC_ACC_REGS:
        total += 4 * mn * bx * bz
    return total


def fused_tc_regs(bx: int, bz: int, mn: int, quant: bool) -> int:
    """Registers per thread, estimated: the MMA accumulators and the H
    fragment, the output accumulators when they are held in registers, one
    A and one B operand fragment, and a fixed allowance for addressing."""
    wz, wx = TC_WARPS[(bx, bz)]
    mt, nt = bz // wz // 16, bx // wx // 8
    frag = mt * nt * 4
    regs = 2 * frag + 4 * mt + 2 * nt + 64
    if mn <= TC_ACC_REGS:
        regs += mn * frag
    return regs


def split_ranges(units: int, splits: int) -> list[tuple[int, int]]:
    """The unit range ``[begin, end)`` of each split, as the kernel computes
    it: ``begin = units * s // splits``."""
    return [(units * s // splits, units * (s + 1) // splits) for s in range(splits)]


@functools.lru_cache(maxsize=4096)
def plan_fused_tc(G: int, X: int, Y: int, Z: int, R: int, m: int, n: int,
                  by: int | None = None, shared_b: bool = False,
                  budget: int = SMEM_BUDGET) -> FusedPlan:
    """Tile and split of the tensor-core fused GEMM + Combine H kernel for
    ``G`` groups of (R, X, Y) x (R, Y, Z); ``by`` is the int8 K-block (None:
    bf16); ``shared_b``: one Bt read by every group.

    The tile is the widest of ``TC_TILES`` whose x side X needs (decode rows
    take the 8-wide tile) and that fits both budgets. ``splits`` is 1 where
    the tiles alone reach ``SMS`` blocks; otherwise enough to reach
    ``SPLIT_MIN_BLOCKS``, at most one unit per split and at most as many
    f32 partials as the operands have bytes (the partials' round trip must
    not outweigh the stream it parallelizes).
    """
    quant = by is not None
    mn = m * n
    if X > 16:
        cands = TC_TILES
    elif X > 8:
        cands = TC_TILES[1:]
    else:
        cands = TC_TILES[2:]
    for bx, bz in cands:
        smem = fused_tc_smem(bx, bz, mn, quant)
        if smem <= budget and fused_tc_regs(bx, bz, mn, quant) <= REGS_PER_THREAD:
            break
    else:
        raise ValueError(f"no tensor-core fused tile fits m*n={mn} accumulator tiles "
                         f"in {budget} bytes of shared memory")
    tiles = G * -(-X // bx) * -(-Z // bz)
    if quant:
        if by < 1 or Y % by:
            raise ValueError(f"K-block {by} does not divide Y = {Y}")
        units, per_unit = R * (Y // by), -(-by // TC_BK)
    else:
        units, per_unit = R * -(-Y // TC_BK), 1
    isz = 1 if quant else 2
    operand_bytes = isz * R * (G * X * Y + (1 if shared_b else G) * Y * Z)
    split_max = max(1, min(units, operand_bytes // (4 * G * mn * X * Z)))
    # blockIdx.z carries (group, split): at most 65,535 of them
    split_max = max(1, min(split_max, 65_535 // G))
    splits = 1 if tiles >= SMS else min(-(-SPLIT_MIN_BLOCKS // tiles), split_max)
    return FusedPlan(bx, bz, TC_BK, TC_STAGES, splits, units, per_unit,
                     mn <= TC_ACC_REGS, smem, tiles, split_max)


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
    per-block shared memory of the part. ``fused_gemm`` is the f32 SIMT
    kernel's tile, ``fused_gemm_tc`` and ``fused_gemm_quant`` the bf16 and
    int8 tensor-core plans (tile, ring depth, split); ``dtype`` is recorded.
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
    ft = plan_fused_tc(1, X, Y, Z, R, m, n, budget=budget)
    fq = plan_fused_tc(1, X, Y, Z, R, m, n, by=by, budget=budget)
    return {
        "grid": [m, k, n], "R": R, "dtype": str(dtype),
        "padded_shape": [Mp, Kp, Np],
        "combine_a": list(ca), "combine_b": list(cb), "fused_gemm": list(fg),
        "fused_gemm_tc": ft.as_dict(),
        "quant_combine_a": {"warps": qw, "by": by}, "fused_gemm_quant": fq.as_dict(),
        "combine_a_smem_bytes": combine_smem(*ca, m * k),
        "combine_b_smem_bytes": combine_smem(*cb, k * n),
        "fused_gemm_smem_bytes": fused_gemm_smem(fg[0], fg[1], m, n),
        "quant_combine_a_smem_bytes": quant_combine_smem(qw, m * k, by),
        "fused_gemm_tc_smem_bytes": ft.smem_bytes,
        "fused_gemm_quant_smem_bytes": fq.smem_bytes,
        "smem_budget_bytes": budget,
    }
