"""On-chip resource planning for the Hopper kernels (paper §III-A).

Picks each kernel's block (CTA) tile from the two budgets that bind on an
H100 SM: the shared memory one block may use (232,448 bytes) and the
registers (at most 255 per thread, 65,536 per SM). The reference planner's
high-rank failure mode — an ``(R, bx, bz)`` f32 accumulator that outgrows
on-chip memory — cannot occur here: the fused kernels finish one rank at a
time and keep only the ``m*n`` output accumulators (see
``csrc/fused_tc.cuh``), so every scheme of the library gets a tile.

The fused kernels (tensor cores for bf16 and int8, FP32 FMAs for f32)
also get a split count S: where the output tiles alone leave the card idle
(decode rows), the flattened (rank, K-chunk) reduction is cut into S
contiguous ranges, one block each, and a second pass sums the S f32
partials in fixed order. The tiled GEMM's tensor-core route splits its K
range the same way. The f32 fused kernel's tile is chosen from the shape
as well: a 32-wide one where Z = 32, an 8-row one for decode rows.

The Group Combine kernel is a stream of 16-byte accesses; its plan is the
route (16-byte loads, or the narrow route's staged pieces for any Y and
alignment), the block shape and the rows each thread or block walks. Its
quantizing form (Combine A fused with the int8 absmax) is one too; its plan
is the route, the lanes per K-block, the units per block and the rank
split.
"""
from __future__ import annotations

import functools
from dataclasses import asdict, dataclass

import numpy as np

__all__ = ["SMEM_BUDGET", "SMEM_PER_SM", "REGS_PER_THREAD", "REGS_PER_SM", "THREADS", "SMS",
           "COMBINE_MIN_BLOCKS", "COMBINE_NARROW_ELEMS", "CombinePlan", "combine_smem",
           "combine_narrow_smem", "combine_regs", "plan_combine",
           "F32_TILES", "F32_TN", "F32_BKS", "F32_STAGES", "F32_PAD", "F32_PAD_B",
           "F32_ACC_REGS", "FusedF32Plan", "fused_f32_pair", "fused_f32_bk",
           "fused_f32_threads", "fused_f32_smem", "fused_f32_regs", "fused_f32_rate",
           "plan_fused_f32",
           "TC_THREADS", "TC_TILES", "TC_WARPS", "TC_BK", "TC_STAGES", "TC_ACC_REGS",
           "SPLIT_MIN_BLOCKS", "FusedPlan", "fused_tc_smem", "fused_tc_regs",
           "plan_fused_tc", "split_ranges",
           "QUANT_COMBINE_THREADS", "QUANT_SPLIT_MIN_BLOCKS", "QuantCombinePlan",
           "quant_combine_smem", "quant_combine_regs", "plan_quant_combine",
           "TILED_F32_TILES", "TILED_F32_BK", "TILED_F32_STAGES", "TILED_F32_PAD",
           "TILED_MMA_TILES", "TILED_MMA_BK", "TILED_MMA_STAGES", "TILED_MMA_PAD",
           "TILED_MMA_MIN_BLOCKS", "TILED_MIN_BLOCKS", "TiledF32Plan", "TiledMmaPlan",
           "tiled_f32_smem", "tiled_f32_regs", "plan_tiled_f32", "tiled_mma_smem",
           "tiled_mma_regs", "plan_tiled_mma",
           "TILED_WG_TILES", "TILED_WG_BK", "TILED_WG_STAGES", "TILED_WG_MIN_KBLOCKS",
           "TiledPlan", "tiled_route", "tiled_wgmma_smem", "tiled_wgmma_threads",
           "tiled_wgmma_regs", "plan_tiled_wgmma", "scale_block", "block_plans"]

SMEM_BUDGET = 232_448      # bytes of shared memory one block may use
SMEM_PER_SM = 233_472      # an SM's shared memory for its blocks (1 KB more kept per block)
REGS_PER_THREAD = 255
REGS_PER_SM = 65_536
THREADS = 256              # most threads a Group Combine block holds
SMS = 132                  # streaming multiprocessors of an H100 SXM

# The f32 fused kernels (csrc/fused_gemm.cu, namespace f32): tiles as (bx,
# bz, tm), a block of (bx/tm) * (bz/F32_TN) threads. Where m*n <=
# F32_ACC_REGS the output accumulators stay in registers: at tm = 8 a pair
# of lanes then shares an 8 x 8 block of H_r (the pair kernel, Bt rows
# padded by F32_PAD_B floats), below it each lane owns tm x
# F32_TN of it; otherwise the accumulators are in shared memory and each
# lane owns tm x F32_TN (the one-lane kernel, At rows padded by F32_PAD
# floats). A ring of F32_STAGES cp.async stages of bk K steps: 8 where Y <=
# 8, else 32 for the pair kernel, 16 for the one-lane kernel (F32_BKS).
F32_TILES = ((64, 64, 8), (128, 32, 8), (32, 64, 4), (64, 32, 4), (8, 64, 2))
F32_TN = 4                 # kTN
F32_BKS = (32, 16, 8)      # the stage depths the kernels instantiate
F32_STAGES = 4             # kStages
F32_PAD = 4                # kPadA
F32_PAD_B = 8              # kPadB
F32_ACC_REGS = 4           # kAccRegs

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
# The tiled GEMM's f32 route (csrc/tiled_matmul.cu, namespace sg: FP32 FMAs
# only): tiles (bm, bn) -> (wm, wn, gm, gn, min_blocks), wm x wn warps, each
# lane gm x gn groups of 4 x 4 outputs, min_blocks blocks an SM in the launch
# bounds; a ring of TILED_F32_STAGES cp.async stages of TILED_F32_BK K steps,
# A stored K-major with rows padded by TILED_F32_PAD floats. Decode rows take
# the 8- and 16-row tiles.
TILED_F32_TILES = {(128, 256): (2, 4, 2, 4, 1), (64, 128): (2, 2, 2, 2, 4),
                   (16, 256): (1, 4, 1, 2, 4), (8, 256): (1, 4, 1, 1, 4)}
TILED_F32_BK = 16          # sg::kBK
TILED_F32_STAGES = 4       # sg::kStages
TILED_F32_PAD = 4          # sg::kPadA
# Its mma.sync route (bf16 TMA cannot address, namespace mm): tiles of bm/64
# warps along m and 4 along n, each warp 64 x 32; a ring of TILED_MMA_STAGES
# stages of TILED_MMA_BK K steps, rows padded by TILED_MMA_PAD elements.
TILED_MMA_TILES = ((128, 128), (64, 128))
TILED_MMA_BK = 32          # mm::kBK
TILED_MMA_STAGES = 4       # mm::kStages
TILED_MMA_PAD = 8          # mm::kPad
TILED_MMA_MIN_BLOCKS = 2   # mma launch bounds: 2 blocks an SM
TILED_MIN_BLOCKS = 128     # blocks that keep (nearly) all 132 SMs busy
# Its tensor-core route (bf16, TMA + wgmma): tiles (bm, bn) with bm/64
# consumer warpgroups and one producer warp, a ring of TILED_WG_STAGES stages
# of TILED_WG_BK K elements (one 128-byte swizzle row of bf16).
TILED_WG_TILES = ((128, 256), (128, 128), (64, 128))
TILED_WG_BK = 64           # kWgBK
TILED_WG_STAGES = 4        # kWgStages
TILED_WG_MIN_KBLOCKS = 4   # K stages a split keeps, at least (fills the ring)
# Group Combine: the grid a call is spread over before a thread takes more rows
COMBINE_MIN_BLOCKS = 4 * SMS
COMBINE_NARROW_ELEMS = 2048  # elements a narrow-route block stages (about)
# Quant Group Combine A (csrc/quant_combine.cu): most threads a block holds
# (kQcThreads), and the grid a small call's rank split aims for (~6 blocks
# an SM: mlp_up's Combine A gets 4 rank groups at prefill, 7 at decode).
QUANT_COMBINE_THREADS = 256
QUANT_SPLIT_MIN_BLOCKS = 6 * SMS


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class CombinePlan:
    """One launch of the Group Combine kernel.

    The vector route: a block of ``ty`` x ``tx`` threads (``ty`` along y in
    vectors of ``vec`` elements, 16 bytes; ``tx`` along x), each thread
    walking ``rows`` rows. The narrow route (``xb`` > 0): a block of ``ty``
    threads (``tx`` = ``rows`` = 1) stages ``xb`` rows x ``yb`` columns of
    one group and writes them in 16-byte stores of ``vec`` elements.
    ``smem_bytes`` as the launcher's layout computes it."""
    vec: int
    ty: int
    tx: int
    rows: int
    smem_bytes: int
    blocks: int
    xb: int = 0
    yb: int = 0

    @property
    def route(self) -> str:
        return "narrow" if self.xb else "vector"

    @property
    def threads(self) -> int:
        return self.ty * self.tx

    def as_dict(self) -> dict:
        return {**asdict(self), "threads": self.threads, "route": self.route}


def combine_smem(nparts: int, threads: int, table_len: int, vec_bytes: int) -> int:
    """Shared memory of one vector-route Group Combine block: each thread's
    ``nparts`` slots of one access (``vec_bytes``: 16; the quantizing
    kernel's scalar route, the itemsize), rounded up to 16 bytes, then the
    scheme's coefficient table of ``table_len`` ints."""
    return -(-nparts * threads * vec_bytes // 16) * 16 + 4 * table_len


def combine_narrow_smem(nparts: int, xb: int, yb: int, table_len: int, itemsize: int) -> int:
    """Shared memory of one narrow-route block, as ``narrow_smem`` in
    csrc/group_combine.cu: two 16-byte guards, the parts' ``xb`` x ``yb``
    pieces, each padded to whole 16-byte vectors, and the coefficient
    table."""
    vec = 16 // itemsize
    return 32 + nparts * -(-xb * yb // vec) * vec * itemsize + 4 * table_len


def combine_regs(vec: int) -> int:
    """Registers per thread, estimated: four 16-byte loads in flight (16),
    the f32 sums and one unpacked slot (2 * vec), and a fixed allowance for
    addressing and the table walk. The parts live in shared memory, so the
    scheme does not change it. The narrow route holds eight loaded elements
    and ``vec`` sums: less."""
    return 16 + 2 * vec + 48


def plan_combine(G: int, X: int, Y: int, coeff, itemsize: int, aligned: bool = True,
                 budget: int = SMEM_BUDGET) -> CombinePlan:
    """Plan of the Group Combine kernel for ``G`` groups of (d1*X, d2*Y) ->
    (R, X, Y) under ``coeff`` (R, d1, d2): its d1*d2 parts, and its CSR
    table (``group_combine.coeff_table``) of R + 1 + 2*nnz ints.

    The vector route where Y is a multiple of 16 bytes of elements and both
    pointers are 16-byte aligned (``aligned``): the block covers the y
    vectors of a row with up to 128 threads and fills up to 256 threads
    with rows; a call too small for ``SMS`` blocks gets smaller blocks (down
    to 64 threads), a large one gives each thread up to 8 rows while the
    grid keeps ``COMBINE_MIN_BLOCKS``. Blocks shrink along x until the slots
    and the table fit ``budget`` and the block's registers
    (:func:`combine_regs`) fit an SM.

    The narrow route otherwise (:func:`_plan_narrow`).
    """
    R, d1, d2 = coeff.shape
    return _plan_combine(G, X, Y, d1 * d2, R + 1 + 2 * int(np.count_nonzero(coeff)),
                         itemsize, aligned, budget)


@functools.lru_cache(maxsize=4096)
def _plan_combine(G, X, Y, nparts, table_len, itemsize, aligned, budget) -> CombinePlan:
    vec = 16 // itemsize
    if not aligned or Y % vec:
        return _plan_narrow(G, X, Y, nparts, table_len, itemsize, budget)
    yv = Y // vec
    ty = min(128, _pow2_at_least(yv))
    tx = min(THREADS // ty, _pow2_at_least(X))

    def blocks(ty, tx, rows):
        return -(-yv // ty) * -(-X // (tx * rows)) * G

    while ty * tx > 64 and blocks(ty, tx, 1) < SMS:
        if tx > 1:
            tx //= 2
        else:
            ty //= 2
    rows = next((r for r in (8, 4, 2) if blocks(ty, tx, r) >= COMBINE_MIN_BLOCKS), 1)
    while (combine_smem(nparts, ty * tx, table_len, 16) > budget
           or combine_regs(vec) * ty * tx > REGS_PER_SM):
        if tx > 1:
            tx //= 2
        elif ty > 1:
            ty //= 2
        else:
            raise ValueError(f"no Group Combine block fits {nparts} parts and a "
                             f"{table_len}-int table in {budget} bytes of shared memory")
    return CombinePlan(vec, ty, tx, rows, combine_smem(nparts, ty * tx, table_len, 16),
                       blocks(ty, tx, rows))


def _plan_narrow(G, X, Y, nparts, table_len, itemsize, budget) -> CombinePlan:
    """The narrow route's block: ``THREADS`` threads staging about
    ``COMBINE_NARROW_ELEMS`` elements (the small calls are latency-bound:
    the more warps a block has, the sooner its one round trip and its sums
    are done; on the card no smaller block was faster by more than 3%).
    Whole rows (``yb`` = Y, ``xb`` of them, the nearest whole
    count) where a row of every part is at most four times that, else one
    row cut into even ``yb``-column pieces (a multiple of 16 bytes of
    elements). Shared memory: :func:`combine_narrow_smem`, within
    ``budget``."""
    vec = 16 // itemsize
    if nparts * (Y + vec) <= 4 * COMBINE_NARROW_ELEMS:
        xb, yb = min(X, max(1, round(COMBINE_NARROW_ELEMS / (nparts * Y)))), Y
    else:                                  # y cut into even pieces
        pieces = -(-nparts * Y // COMBINE_NARROW_ELEMS)
        xb, yb = 1, -(-(-(-Y // pieces)) // vec) * vec
    smem = combine_narrow_smem(nparts, xb, yb, table_len, itemsize)
    if smem > budget:
        raise ValueError(f"no narrow Group Combine block fits {nparts} parts and a "
                         f"{table_len}-int table in {budget} bytes of shared memory")
    return CombinePlan(vec, THREADS, 1, 1, smem, -(-X // xb) * -(-Y // yb) * G, xb, yb)


@dataclass(frozen=True)
class QuantCombinePlan:
    """One launch of the quant Group Combine A kernel: ``vec`` elements per
    access (16 bytes: the vector route; 1: the scalar route), ``lanes``
    lanes per K-block of ``by`` columns, blocks of ``threads`` threads
    holding ``units`` (row, K-block) pairs each, consecutive in row-major
    order, the R ranks cut into ``splits`` groups, one block each;
    ``smem_bytes`` as the launcher's layout computes it."""
    vec: int
    by: int
    lanes: int
    splits: int
    threads: int
    smem_bytes: int
    blocks: int

    @property
    def route(self) -> str:
        return "vector" if self.vec > 1 else "scalar"

    @property
    def per_lane(self) -> int:
        """Vectors each lane walks (more than one where by / vec > 32)."""
        return -(-(self.by // self.vec) // self.lanes)

    @property
    def units(self) -> int:
        return self.threads // self.lanes

    def as_dict(self) -> dict:
        return {**asdict(self), "route": self.route, "per_lane": self.per_lane,
                "units": self.units}


def quant_combine_smem(nparts: int, per_lane: int, threads: int, table_len: int,
                       vec_bytes: int) -> int:
    """Shared memory of one quant Group Combine block: each thread's
    ``nparts * per_lane`` slots of one access (``vec_bytes``: 16, or the
    itemsize on the scalar route), rounded up to 16 bytes, then the
    coefficient table of ``table_len`` ints."""
    return combine_smem(nparts * per_lane, threads, table_len, vec_bytes)


def quant_combine_regs(vec: int) -> int:
    """Registers per thread, estimated: four 16-byte loads in flight (16),
    the f32 sums, one unpacked slot and the rounded q values (3 * vec), and
    a fixed allowance for addressing and the table walk."""
    return 16 + 3 * vec + 48


def plan_quant_combine(X: int, Y: int, coeff, itemsize: int, by: int,
                       aligned: bool = True, budget: int = SMEM_BUDGET) -> QuantCombinePlan:
    """Plan of the quant Group Combine A kernel for (d1*X, d2*Y) -> q (R, X,
    Y), scales (R, X, Y/by) under ``coeff`` (R, d1, d2).

    The vector route (16 bytes of elements per access) where ``by`` is a
    multiple of it and the input is 16-byte aligned (``aligned``; the
    outputs are fresh allocations), else the scalar route. A K-block gets
    by/vec lanes rounded up to a power of two, at most 32. Blocks hold up
    to ``QUANT_COMBINE_THREADS`` threads, fewer (down to 64) where the call
    gives fewer than ``SMS`` blocks, and shrink until the slots and the
    table fit ``budget`` and the registers an SM; a grid still under
    ``QUANT_SPLIT_MIN_BLOCKS`` blocks splits the ranks to reach it.
    """
    R, d1, d2 = coeff.shape
    return _plan_quant_combine(X, Y, R, d1 * d2, R + 1 + 2 * int(np.count_nonzero(coeff)),
                               itemsize, by, aligned, budget)


@functools.lru_cache(maxsize=4096)
def _plan_quant_combine(X, Y, R, nparts, table_len, itemsize, by, aligned,
                        budget) -> QuantCombinePlan:
    if by < 1 or Y % by:
        raise ValueError(f"quant Group Combine: K-block {by} does not divide Y = {Y}")
    wide = 16 // itemsize
    vec = wide if aligned and by % wide == 0 else 1
    nv = by // vec
    lanes = min(32, _pow2_at_least(nv))
    per_lane = -(-nv // lanes)
    units = X * (Y // by)
    threads = min(QUANT_COMBINE_THREADS, max(32, _pow2_at_least(units * lanes)))

    def blocks(threads):
        return -(-units // (threads // lanes))

    while threads > 64 and blocks(threads) < SMS:
        threads //= 2
    vec_bytes = vec * itemsize
    while (quant_combine_smem(nparts, per_lane, threads, table_len, vec_bytes) > budget
           or quant_combine_regs(vec) * threads > REGS_PER_SM):
        if threads == 32:
            raise ValueError(f"no quant Group Combine block fits {nparts} parts of a "
                             f"{by}-column K-block and a {table_len}-int table in "
                             f"{budget} bytes of shared memory")
        threads //= 2
    b = blocks(threads)
    splits = 1 if b >= QUANT_SPLIT_MIN_BLOCKS else min(R, -(-QUANT_SPLIT_MIN_BLOCKS // b))
    return QuantCombinePlan(vec, by, lanes, splits, threads,
                            quant_combine_smem(nparts, per_lane, threads, table_len, vec_bytes),
                            b * splits)


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


@dataclass(frozen=True)
class FusedF32Plan:
    """One launch of the f32 fused kernel: a ``bx`` x ``bz`` output tile
    (rows of A x columns of B) over ``threads`` threads, ``tm`` its rows of
    H_r a lane (``pair``: a pair of lanes shares an 8 x 8 block); the
    reduction over (rank, K) a sequence of ``units`` steps of ``bk`` K
    elements through a ring of ``stages`` stages, cut into ``splits``
    contiguous ranges (:func:`split_ranges`), one block each, at most
    ``split_max``; ``splits > 1`` needs a (splits, G, m*n, X, Z) f32
    workspace. ``acc_in_regs``: the m*n output accumulators in registers,
    else in shared memory."""
    bx: int
    bz: int
    tm: int
    bk: int
    stages: int
    threads: int
    splits: int
    units: int
    acc_in_regs: bool
    smem_bytes: int
    tiles: int
    split_max: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def pair(self) -> bool:
        return fused_f32_pair(self.tm, self.acc_in_regs)

    def as_dict(self) -> dict:
        return {**asdict(self), "blocks": self.blocks, "pair": self.pair}


def fused_f32_pair(tm: int, acc_in_regs: bool) -> bool:
    """Whether a tile runs the pair kernel: tm = 8 with the accumulators in
    registers."""
    return tm == 8 and acc_in_regs


def fused_f32_bk(Y: int, pair: bool) -> int:
    """The stage depth: 8 K steps where Y <= 8, else 32 (pair kernel) or 16."""
    return F32_BKS[2] if Y <= F32_BKS[2] else F32_BKS[0] if pair else F32_BKS[1]


def fused_f32_threads(bx: int, bz: int, tm: int) -> int:
    return (bx // tm) * (bz // F32_TN)


def fused_f32_smem(bx: int, bz: int, tm: int, bk: int, mn: int, R: int) -> int:
    """Shared memory of one f32 fused block of an R-rank scheme, as
    ``PairTile::bytes`` and ``Tile::bytes`` in csrc/fused_gemm.cu: the ring,
    per stage an At tile [bx][bk + F32_PAD] and a Bt tile [bk][bz +
    F32_PAD_B] (pair kernel, then W as R dense rows of F32_ACC_REGS) or
    [bk][bz], and the m*n f32 output accumulators where they do not stay in
    registers."""
    if fused_f32_pair(tm, mn <= F32_ACC_REGS):
        ring = F32_STAGES * (bx * (bk + F32_PAD) + bk * (bz + F32_PAD_B))
        return 4 * (ring + F32_ACC_REGS * R)
    ring = F32_STAGES * (bx * (bk + F32_PAD) + bk * bz)
    return 4 * (ring + (0 if mn <= F32_ACC_REGS else mn * bx * bz))


def fused_f32_regs(tm: int, mn: int) -> int:
    """Registers per thread, estimated: a lane's H_r values (the pair
    kernel: 64, an 8 x 8 block; else tm x F32_TN), its output accumulators
    where m*n <= F32_ACC_REGS (the pair kernel: half its block, 32, per part;
    else tm x F32_TN per part), its shared-memory operands (18; 20) and an
    allowance of 40 for addressing, the ring's cursor and the coefficient
    walk."""
    regs_acc = mn <= F32_ACC_REGS
    if fused_f32_pair(tm, regs_acc):
        return 64 + 32 * mn + 18 + 40
    e = tm * F32_TN
    return e * (1 + (mn if regs_acc else 0)) + 4 * F32_TN + 4 + 40


def fused_f32_rate(tm: int, pair: bool) -> float:
    """FMAs per 16 bytes read from shared memory: the pair kernel's lane,
    128 FMAs for 128 bytes a group of 2 K steps; a tm x F32_TN lane, 16 * tm
    FMAs against tm At loads and 4 Bt loads (16 bytes each) per 4 K steps."""
    return 16.0 if pair else 16 * tm / (tm + 4)


@functools.lru_cache(maxsize=4096)
def plan_fused_f32(G: int, X: int, Y: int, Z: int, R: int, m: int, n: int,
                   shared_b: bool = False, budget: int = SMEM_BUDGET) -> FusedF32Plan:
    """Tile, stage depth and split of the f32 fused GEMM + Combine H kernel
    for ``G`` groups of (R, X, Y) x (R, Y, Z); ``shared_b``: one Bt read by
    every group.

    Of the tiles in ``F32_TILES`` that fit the shared-memory budget (the
    ring at the stage depth :func:`fused_f32_bk` gives, and the m*n
    accumulator tiles where m*n > F32_ACC_REGS) and the registers, the one
    with the least padded work (rows and columns rounded up to whole tiles)
    per unit of its FMAs per shared load (:func:`fused_f32_rate`); a tie
    goes to the less padded work, then to the larger tile. So the SSD
    leaves with Z = 32 take a 32-wide tile, decode rows the 8-row one, and
    every scheme up to s555 a tile.
    ``splits`` as :func:`plan_fused_tc` sets it: 1 where the tiles alone
    reach ``SMS`` blocks, else enough to reach ``SPLIT_MIN_BLOCKS``, at most
    one step per split and at most as many f32 partials as the operands
    have bytes.
    """
    mn = m * n
    acc_regs = mn <= F32_ACC_REGS
    best = None
    for bx, bz, tm in F32_TILES:
        pair = fused_f32_pair(tm, acc_regs)
        bk = fused_f32_bk(Y, pair)
        threads = fused_f32_threads(bx, bz, tm)
        regs = fused_f32_regs(tm, mn)
        smem = fused_f32_smem(bx, bz, tm, bk, mn, R)
        if smem > budget or regs > REGS_PER_THREAD or regs * threads > REGS_PER_SM:
            continue
        padded = -(-X // bx) * bx * -(-Z // bz) * bz
        cost = (padded / fused_f32_rate(tm, pair), padded, -bx * bz)
        if best is None or cost < best[0]:
            best = (cost, bx, bz, tm, bk, threads, smem)
    if best is None:
        raise ValueError(f"no f32 fused tile fits m*n={mn} accumulator tiles in "
                         f"{budget} bytes of shared memory")
    _, bx, bz, tm, bk, threads, smem = best
    tiles = G * -(-X // bx) * -(-Z // bz)
    units = R * -(-Y // bk)
    operand_bytes = 4 * R * (G * X * Y + (1 if shared_b else G) * Y * Z)
    split_max = max(1, min(units, operand_bytes // (4 * G * mn * X * Z)))
    split_max = max(1, min(split_max, 65_535 // G))   # blockIdx.z carries (group, split)
    splits = 1 if tiles >= SMS else min(-(-SPLIT_MIN_BLOCKS // tiles), split_max)
    return FusedF32Plan(bx, bz, tm, bk, F32_STAGES, threads, splits, units, acc_regs, smem,
                        tiles, split_max)


def tiled_route(dtype: str, K: int, N: int, a_ptr: int, b_ptr: int) -> str:
    """The tiled GEMM's route, decided before the launch: ``"wgmma"`` for
    bf16 operands TMA can address (K and N multiples of 8, so every row
    stride is a multiple of 16 bytes, and both base pointers 16-byte
    aligned), ``"mma"`` for other bf16 (tensor cores through mma.sync), and
    ``"f32"`` for f32 operands (FP32 FMAs: TF32 would break the f32
    tolerance)."""
    if dtype != "bfloat16":
        return "f32"
    ok = K % 8 == 0 and N % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0
    return "wgmma" if ok else "mma"


def _resident(smem: int, min_blocks: int) -> int:
    """Blocks an SM holds of a tiled-GEMM kernel: as many as its shared
    memory allows (1 KB more kept per block), at most the ``min_blocks`` its
    launch bounds guarantee registers for."""
    return max(1, min(SMEM_PER_SM // (smem + 1024), min_blocks))


def _fill_splits(M: int, K: int, N: int, tiles: int, resident: int, bk: int,
                 itemsize: int) -> int:
    """K splits of the f32 and mma routes: 1 where the tiles fill the
    resident blocks of every SM, else as many as fill them, each split
    keeping at least TILED_WG_MIN_KBLOCKS stages and the f32 partials no
    more bytes than the operands."""
    if tiles >= SMS * resident:
        return 1
    split_max = max(1, min(-(-K // bk) // TILED_WG_MIN_KBLOCKS,
                           itemsize * (M * K + K * N) // (4 * M * N), 65_535))
    return max(1, min(SMS * resident // tiles, split_max))


def tiled_f32_smem(bm: int, bn: int) -> int:
    """Shared memory of one f32 tiled-GEMM block, as ``sg::Tile::kBytes``:
    TILED_F32_STAGES stages of A^T [bk][bm + pad] and B [bk][bn], f32."""
    return 4 * TILED_F32_STAGES * TILED_F32_BK * (bm + TILED_F32_PAD + bn)


def tiled_f32_regs(bm: int, bn: int) -> int:
    """Registers per thread of the f32 route, estimated: the lane's gm*4 x
    gn*4 accumulators, two buffers of its A and B fragments, and 24 for
    addressing and the ring; the launch bounds cap it at REGS_PER_SM /
    (threads * min_blocks), at most 255."""
    _, _, gm, gn, _ = TILED_F32_TILES[(bm, bn)]
    tm, tn = 4 * gm, 4 * gn
    return tm * tn + 2 * (tm + tn) + 24


@dataclass(frozen=True)
class TiledF32Plan:
    """One launch of the tiled GEMM's f32 route: a ``bm`` x ``bn`` tile over
    ``wm`` x ``wn`` warps, each lane ``tm`` x ``tn`` outputs; a ring of
    ``stages`` stages of ``bk`` K steps; B copied and C stored 16 bytes at a
    time where ``vec``; the K range split across ``splits`` blocks per tile
    (an f32 (splits, M, N) workspace and a fixed-order reduce pass when > 1)."""
    bm: int
    bn: int
    wm: int
    wn: int
    tm: int
    tn: int
    bk: int
    stages: int
    threads: int
    vec: bool
    splits: int
    tiles: int
    smem_bytes: int
    regs: int
    resident: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def as_dict(self) -> dict:
        return {**asdict(self), "blocks": self.blocks}


@functools.lru_cache(maxsize=4096)
def plan_tiled_f32(M: int, K: int, N: int, vec: bool = True) -> TiledF32Plan:
    """Tile and split of the f32 tiled GEMM for (M, K) @ (K, N).

    Rows M <= 8 take the 8 x 256 tile, M <= 16 the 16 x 256 one (decode
    rows: a stream over B with no more wasted rows than the kernel's 4-row
    groups need), M <= 64 the 64 x 128 one (each lane 8 x 8 outputs), larger
    M the 128 x 256 one (each lane 8 x 16: 128 FMAs for 6 shared-memory
    reads). Where the tiles do not fill the resident blocks of every SM
    (short-M probes, decode rows), K is split (:func:`_fill_splits`).
    ``vec``: N % 4 == 0 and B and C 16-byte aligned (the wrapper's check)."""
    if M <= 8:
        bm, bn = 8, 256
    elif M <= 16:
        bm, bn = 16, 256
    elif M <= 64:
        bm, bn = 64, 128
    else:
        bm, bn = 128, 256
    wm, wn, gm, gn, min_blocks = TILED_F32_TILES[(bm, bn)]
    threads = 32 * wm * wn
    smem = tiled_f32_smem(bm, bn)
    resident = _resident(smem, min_blocks)
    tiles = -(-M // bm) * -(-N // bn)
    splits = _fill_splits(M, K, N, tiles, resident, TILED_F32_BK, 4)
    return TiledF32Plan(bm, bn, wm, wn, 4 * gm, 4 * gn, TILED_F32_BK, TILED_F32_STAGES, threads,
                        bool(vec), splits, tiles, smem, tiled_f32_regs(bm, bn), resident)


def tiled_mma_smem(bm: int) -> int:
    """Shared memory of one mma tiled-GEMM block, as ``mm::Layout::kBytes``:
    TILED_MMA_STAGES ring stages of A [bm][bk + pad] and B [bk][128 + pad],
    bf16, and one more stage that an operand staged raw is repacked into."""
    bk, pad = TILED_MMA_BK, TILED_MMA_PAD
    return 2 * (TILED_MMA_STAGES + 1) * (bm * (bk + pad) + bk * (128 + pad))


def tiled_mma_regs(bm: int) -> int:
    """Registers per thread of the mma route, estimated: 64 accumulators of
    the warp's 64 x 32 tile, one k16 step's A and B fragments (16 + 8), and
    32 for addressing and the ring; the launch bounds (TILED_MMA_MIN_BLOCKS
    blocks an SM) cap it at 128 for 256 threads, 255 for 128."""
    return 64 + 24 + 32


@dataclass(frozen=True)
class TiledMmaPlan:
    """One launch of the tiled GEMM's mma route: a ``bm`` x ``bn`` tile of
    ``threads`` threads, a ring of ``stages`` stages of ``bk`` K steps; A
    (``vec_a``) and B (``vec_b``) staged by 16-byte copies where their row
    stride and pointer allow, else by gathered element pairs; the K range
    split across ``splits`` blocks per tile."""
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    vec_a: bool
    vec_b: bool
    splits: int
    tiles: int
    smem_bytes: int
    regs: int
    resident: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def as_dict(self) -> dict:
        return {**asdict(self), "blocks": self.blocks}


@functools.lru_cache(maxsize=4096)
def plan_tiled_mma(M: int, K: int, N: int, vec_a: bool = False,
                   vec_b: bool = False) -> TiledMmaPlan:
    """Tile and split of the mma tiled GEMM for bf16 (M, K) @ (K, N) that TMA
    cannot address: the 64 x 128 tile for M <= 64, else 128 x 128; K split
    where the tiles do not fill the resident blocks (:func:`_fill_splits`).
    ``vec_a``/``vec_b``: that operand's row stride is a multiple of 8
    elements and its pointer 16-byte aligned."""
    bm, bn = TILED_MMA_TILES[1] if M <= 64 else TILED_MMA_TILES[0]
    threads = bm // 64 * 128
    smem = tiled_mma_smem(bm)
    resident = _resident(smem, TILED_MMA_MIN_BLOCKS)
    tiles = -(-M // bm) * -(-N // bn)
    splits = _fill_splits(M, K, N, tiles, resident, TILED_MMA_BK, 2)
    return TiledMmaPlan(bm, bn, TILED_MMA_BK, TILED_MMA_STAGES, threads, bool(vec_a),
                        bool(vec_b), splits, tiles, smem, tiled_mma_regs(bm), resident)


def tiled_wgmma_smem(bm: int, bn: int) -> int:
    """Shared memory of one tensor-core tiled-GEMM block, as
    ``WgLayout::kBytes`` in csrc/tiled_matmul.cu: 1024 bytes of slack to
    align the ring, TILED_WG_STAGES stages of a bm x 64 A tile and a 64 x bn
    B tile in bf16, and a full and an empty mbarrier per stage."""
    return 1024 + TILED_WG_STAGES * (bm + bn) * TILED_WG_BK * 2 + 2 * TILED_WG_STAGES * 8


def tiled_wgmma_threads(bm: int) -> int:
    """bm/64 consumer warpgroups and one producer warp."""
    return bm // 64 * 128 + 32


def tiled_wgmma_regs(bn: int) -> int:
    """Registers per consumer thread, estimated: the m64n{bn} f32
    accumulators (bn/2) and a fixed allowance for the ring, descriptors and
    epilogue addressing."""
    return bn // 2 + 56


@dataclass(frozen=True)
class TiledPlan:
    """One launch of the tiled GEMM's tensor-core route: a ``bm`` x ``bn``
    output tile per block, a ring of ``stages`` stages of ``bk`` K
    elements, the K range split across ``splits`` blocks per tile (an f32
    (splits, M, N) workspace and a fixed-order reduce pass when > 1)."""
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    tiles: int
    smem_bytes: int
    threads: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def as_dict(self) -> dict:
        return {**asdict(self), "blocks": self.blocks}


@functools.lru_cache(maxsize=4096)
def plan_tiled_wgmma(M: int, K: int, N: int) -> TiledPlan:
    """Tile and split of the tensor-core tiled GEMM for (M, K) @ (K, N).

    Rows M <= 64 (decode) take the 64 x 128 tile (one consumer warpgroup,
    two blocks an SM). Otherwise the 128 x 256 tile where its grid has
    ``TILED_MIN_BLOCKS`` blocks, else 128 x 128 (fewer re-reads of A and B
    from L2 than a narrower tile). Where the tiles alone stay under
    ``TILED_MIN_BLOCKS`` (short-M probes, decode rows), K is split into as
    many ranges as the resident blocks allow, each of at least
    ``TILED_WG_MIN_KBLOCKS`` stages, with no more f32 partial bytes than
    the operands have.
    """
    def tiles(bm, bn):
        return -(-M // bm) * -(-N // bn)

    if M <= 64:
        cands = TILED_WG_TILES[2:]
    elif tiles(*TILED_WG_TILES[0]) >= TILED_MIN_BLOCKS:
        cands = TILED_WG_TILES
    else:
        cands = TILED_WG_TILES[1:]
    bm, bn = next((bm, bn) for bm, bn in cands if tiled_wgmma_smem(bm, bn) <= SMEM_BUDGET
                  and tiled_wgmma_regs(bn) * tiled_wgmma_threads(bm) <= REGS_PER_SM)
    smem = tiled_wgmma_smem(bm, bn)
    t = tiles(bm, bn)
    splits = 1
    if t < TILED_MIN_BLOCKS:
        resident = SMS * max(1, SMEM_PER_SM // (smem + 1024))
        kblocks = -(-K // TILED_WG_BK)
        operand_bytes = 2 * (M * K + K * N)
        split_max = max(1, min(kblocks // TILED_WG_MIN_KBLOCKS,
                               operand_bytes // (4 * M * N), 65_535))
        splits = max(1, min(resident // t, split_max))
    return TiledPlan(bm, bn, TILED_WG_BK, TILED_WG_STAGES, splits, t, smem,
                     tiled_wgmma_threads(bm))


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
    per-block shared memory of the part. ``combine_a``/``combine_b`` are
    the Group Combine plans (vector width, block, rows; 16-byte aligned
    operands assumed), ``quant_combine_a`` the quant Group Combine A plan
    (route, lanes, units per block, rank split; aligned input assumed),
    ``fused_gemm`` the f32 kernel's plan (tile, micro-tile, stage depth,
    split),
    ``fused_gemm_tc`` and ``fused_gemm_quant`` the bf16 and int8
    tensor-core plans (tile, ring depth, split); ``dtype`` is recorded.
    """
    budget = SMEM_BUDGET
    if hw is not None and getattr(hw, "vmem_bytes", None):
        budget = min(budget, int(hw.vmem_bytes))
    m, k, n, R = l.m, l.k, l.n, l.R
    Mp, Kp, Np = -(-M // m) * m, -(-K // k) * k, -(-N // n) * n
    X, Y, Z = Mp // m, Kp // k, Np // n
    isz = 2 if str(dtype) == "bfloat16" else 4
    ca = plan_combine(1, X, Y, l.U, isz, budget=budget)
    cb = plan_combine(1, Y, Z, l.V, isz, budget=budget)
    fg = plan_fused_f32(1, X, Y, Z, R, m, n, budget=budget)
    by = scale_block(Y)
    qc = plan_quant_combine(X, Y, l.U, isz, by, budget=budget)
    ft = plan_fused_tc(1, X, Y, Z, R, m, n, budget=budget)
    fq = plan_fused_tc(1, X, Y, Z, R, m, n, by=by, budget=budget)
    return {
        "grid": [m, k, n], "R": R, "dtype": str(dtype),
        "padded_shape": [Mp, Kp, Np],
        "combine_a": ca.as_dict(), "combine_b": cb.as_dict(), "fused_gemm": fg.as_dict(),
        "fused_gemm_tc": ft.as_dict(),
        "quant_combine_a": qc.as_dict(), "fused_gemm_quant": fq.as_dict(),
        "combine_a_smem_bytes": ca.smem_bytes,
        "combine_b_smem_bytes": cb.smem_bytes,
        "fused_gemm_smem_bytes": fg.smem_bytes,
        "quant_combine_a_smem_bytes": qc.smem_bytes,
        "fused_gemm_tc_smem_bytes": ft.smem_bytes,
        "fused_gemm_quant_smem_bytes": fq.smem_bytes,
        "smem_budget_bytes": budget,
    }
