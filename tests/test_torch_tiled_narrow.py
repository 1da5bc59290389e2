"""The tiled GEMM's f32 and mma routes and Group Combine's narrow route, on
the CPU.

Their plans fit the H100 (shared memory, registers, grid) at the tune
probes, decode rows and ragged and misaligned shapes; a Python walk of each
plan (the f32 route's tiles, lane layout, K splits and stages; the mma
route's warp tiles and its raw-row staging of unaligned operands; the
narrow route's pieces and its 16-byte runs on the output's own grid) gives
the plain result; and the wrappers' CPU path matches the reference's Pallas
kernels in interpret mode (f32 sums in another order: 1e-5; bf16 one
rounding of each: the reference kernel tests' atol 6e-2 / rtol 2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.kernels import ops as jops
from repro.kernels.group_combine import (batched_group_combine as j_bcombine,
                                         group_combine as j_combine)
from repro_torch import kernels as K
from repro_torch.core import algorithms as talg
from repro_torch.kernels import tuning

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=6e-2, rtol=2e-2)}

# (M, K, N): the tune probes, decode rows, ragged and tiny shapes
SHAPES = [(4096, 4096, 4096), (256, 2048, 8192), (256, 8192, 2048), (4, 2048, 8192),
          (16, 2048, 8192), (64, 2048, 8192), (13, 23, 17), (64, 101, 72), (1, 8, 8),
          (300, 1000, 520), (4096, 4096, 4100)]


def _ids(t):
    return "x".join(map(str, t))


@pytest.mark.parametrize("mkn", SHAPES, ids=_ids)
def test_tiled_f32_plan_fits(mkn):
    """A tile the source instantiates, its shared memory within a block's
    budget, its registers within its launch bounds, its grid within the
    launch limits; splits only where the tiles leave resident blocks idle,
    each split keeping whole stages."""
    M, K_, N = mkn
    for vec in (True, False):
        p = tuning.plan_tiled_f32(M, K_, N, vec=vec)
        wm, wn, gm, gn, min_blocks = tuning.TILED_F32_TILES[(p.bm, p.bn)]
        assert (p.wm, p.wn, p.tm, p.tn) == (wm, wn, 4 * gm, 4 * gn) and p.vec == vec
        assert p.threads == 32 * wm * wn and (p.bk, p.stages) == (tuning.TILED_F32_BK,
                                                                   tuning.TILED_F32_STAGES)
        assert p.smem_bytes == tuning.tiled_f32_smem(p.bm, p.bn) <= tuning.SMEM_BUDGET
        assert p.regs <= min(tuning.REGS_PER_THREAD,
                             tuning.REGS_PER_SM // (p.threads * min_blocks))
        assert p.tiles == -(-M // p.bm) * -(-N // p.bn) and -(-M // p.bm) <= 65_535
        assert p.splits == 1 or (p.tiles < tuning.SMS * p.resident
                                 and -(-K_ // p.bk) // p.splits >= tuning.TILED_WG_MIN_KBLOCKS)


@pytest.mark.parametrize("mkn", SHAPES, ids=_ids)
def test_tiled_mma_plan_fits(mkn):
    """The mma route's tile, shared memory (the ring and the repack stage),
    registers and grid at every shape, for each staging of the operands."""
    M, K_, N = mkn
    for va, vb in ((False, False), (True, False), (False, True)):
        p = tuning.plan_tiled_mma(M, K_, N, vec_a=va, vec_b=vb)
        assert (p.bm, p.bn) in tuning.TILED_MMA_TILES and (p.vec_a, p.vec_b) == (va, vb)
        assert p.threads == p.bm // 64 * 128
        assert p.smem_bytes == tuning.tiled_mma_smem(p.bm) <= tuning.SMEM_BUDGET
        assert p.regs <= min(tuning.REGS_PER_THREAD,
                             tuning.REGS_PER_SM // (p.threads * tuning.TILED_MMA_MIN_BLOCKS))
        assert p.tiles == -(-M // p.bm) * -(-N // p.bn)
        assert p.splits == 1 or -(-K_ // p.bk) // p.splits >= tuning.TILED_WG_MIN_KBLOCKS


def test_tiled_plans_at_the_probes():
    """4096^3 on the 128 x 256 tile, one block an SM, no split; the short-M
    probes split K until the resident blocks are full; decode rows on the
    8-row tile."""
    big = tuning.plan_tiled_f32(4096, 4096, 4096)
    assert (big.bm, big.bn, big.tm, big.tn, big.splits) == (128, 256, 8, 16, 1)
    for mkn in ((256, 2048, 8192), (256, 8192, 2048)):
        p = tuning.plan_tiled_f32(*mkn)
        assert p.splits > 1 and p.blocks <= tuning.SMS * p.resident
    dec = tuning.plan_tiled_f32(4, 2048, 8192)
    assert dec.bm == 8 and dec.splits > 1 and dec.blocks >= tuning.SMS
    assert tuning.plan_tiled_mma(4, 2048, 8192).bm == 64
    assert tuning.plan_tiled_mma(256, 2048, 8192).bm == 128


@pytest.mark.parametrize("mkn", [(13, 23, 17), (300, 100, 520), (4, 200, 700),
                                 (40, 96, 300), (260, 64, 1300)], ids=_ids)
def test_f32_plan_walk_gives_the_plain_result(mkn, rng):
    """Walk the f32 plan as the kernel does: every block's tile, its K range
    of whole stages in its split, each lane's outputs (groups of 4 x 4
    strided by the warp's lanes); zero-filled edges; partials summed in
    split order. Every output is owned once and the sum is A @ B."""
    M, K_, N = mkn
    p = tuning.plan_tiled_f32(M, K_, N)
    a, b = rng.standard_normal((M, K_)), rng.standard_normal((K_, N))
    gx, gy = -(-N // p.bn), -(-M // p.bm)
    kblocks = -(-K_ // p.bk)
    lm = p.bm // (p.wm * p.tm)           # lanes of a warp along m
    ln = 32 // lm
    ws = np.zeros((p.splits, M, N))
    owned = np.zeros((p.splits, M, N), int)
    for s in range(p.splits):
        kb0, kb1 = kblocks * s // p.splits, kblocks * (s + 1) // p.splits
        assert kb1 > kb0
        for by in range(gy):
            for bx in range(gx):
                m0, n0 = by * p.bm, bx * p.bn
                acc = np.zeros((p.bm, p.bn))
                for kb in range(kb0, kb1):            # one ring stage at a time
                    at = np.zeros((p.bm, p.bk))
                    bt = np.zeros((p.bk, p.bn))
                    ra = a[m0:m0 + p.bm, kb * p.bk:(kb + 1) * p.bk]
                    rb = b[kb * p.bk:(kb + 1) * p.bk, n0:n0 + p.bn]
                    at[:ra.shape[0], :ra.shape[1]] = ra
                    bt[:rb.shape[0], :rb.shape[1]] = rb
                    acc += at @ bt
                for t in range(p.threads):
                    warp, lane = divmod(t, 32)
                    am = warp // p.wn * (p.bm // p.wm) + lane // ln * 4
                    bn = warp % p.wn * (p.bn // p.wn) + lane % ln * 4
                    for x in range(p.tm):
                        row = am + x // 4 * lm * 4 + x % 4
                        for y in range(p.tn):
                            col = bn + y // 4 * ln * 4 + y % 4
                            if m0 + row < M and n0 + col < N:
                                ws[s, m0 + row, n0 + col] = acc[row, col]
                                owned[s, m0 + row, n0 + col] += 1
    assert (owned == 1).all()
    out = ws[0]
    for s in range(1, p.splits):
        out = out + ws[s]
    np.testing.assert_allclose(out, a @ b, rtol=1e-12, atol=1e-12)


def _raw_row(mem: np.ndarray, first: int, end: int, chunks: int) -> np.ndarray:
    """mm::copy_raw of one row: the 16-byte chunks (8 bf16 slots) from the
    one holding element ``first`` of ``mem`` on; slots at or past ``end``
    zero-filled."""
    at = first // 8 * 8
    raw = np.zeros(chunks * 8, mem.dtype)
    for j in range(chunks * 8):
        if at + j < end:
            raw[j] = mem[at + j]
    return raw


def _unshift(raw: np.ndarray, shift_bytes: int, n: int) -> np.ndarray:
    """mm::unshift2 over a row: n elements starting ``shift_bytes`` in, read
    as 32-bit words (a byte permute of two where the shift is odd in
    elements)."""
    words = raw.view(np.uint32)
    out = np.zeros(n // 2, np.uint32)
    for j in range(n // 2):
        at = shift_bytes + 4 * j
        if at % 4:
            lo, hi = words[(at - 2) // 4], words[(at + 2) // 4]
            out[j] = (lo >> 16) | ((hi & 0xFFFF) << 16)
        else:
            out[j] = words[at // 4]
    return out.view(np.uint16)


@pytest.mark.parametrize("offset,K_", [(1, 64), (1, 37), (0, 37), (3, 2048), (2, 101)])
def test_mma_raw_staging_gives_the_rows(offset, K_, rng):
    """The mma route's staging of an operand TMA cannot address: each row's
    raw 16-byte chunks (bytes past the row's end zero-filled), shifted by the
    row's misalignment, give the stage's elements of that row and zeros past
    K, for every row and stage, at any 2-byte offset and odd row strides."""
    rows, bk, pad = 5, tuning.TILED_MMA_BK, tuning.TILED_MMA_PAD
    mem = rng.integers(1, 2 ** 15, offset + rows * K_ + 16).astype(np.uint16)
    chunks = (bk + pad) * 2 // 16
    for r in range(rows):
        start = offset + r * K_
        for k0 in range(0, K_, bk):
            raw = _raw_row(mem, start + k0, start + K_, chunks)
            shift = start % 8 * 2      # bytes; k0 keeps it (64 bytes a stage)
            got = _unshift(raw, shift, bk)
            want = np.zeros(bk, np.uint16)
            n = min(bk, K_ - k0)
            want[:n] = mem[start + k0:start + k0 + n]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mkn", [(13, 23, 17), (200, 77, 300), (65, 64, 129)], ids=_ids)
def test_mma_plan_walk_gives_the_plain_result(mkn, rng):
    """Walk the mma plan: every block's tile, its K range in whole stages,
    each warp's 64 x 32 tile and each lane's m16n8 accumulator places; every
    output owned once, and the sum is A @ B."""
    M, K_, N = mkn
    p = tuning.plan_tiled_mma(M, K_, N)
    a, b = rng.standard_normal((M, K_)), rng.standard_normal((K_, N))
    kblocks = -(-K_ // p.bk)
    out = np.zeros((p.splits, M, N))
    owned = np.zeros((M, N), int)
    for s in range(p.splits):
        kb0, kb1 = kblocks * s // p.splits, kblocks * (s + 1) // p.splits
        for m0 in range(0, M, p.bm):
            for n0 in range(0, N, p.bn):
                ap = np.zeros((p.bm, kblocks * p.bk))
                bp = np.zeros((kblocks * p.bk, p.bn))
                blk_a = a[m0:m0 + p.bm]
                blk_b = b[:, n0:n0 + p.bn]
                ap[:blk_a.shape[0], :K_] = blk_a
                bp[:K_, :blk_b.shape[1]] = blk_b
                acc = ap[:, kb0 * p.bk:kb1 * p.bk] @ bp[kb0 * p.bk:kb1 * p.bk]
                for warp in range(p.threads // 32):
                    wm, wn = warp // 4 * 64, warp % 4 * 32
                    for lane in range(32):
                        for mt in range(4):
                            for nt in range(4):
                                for e in range(4):
                                    row = wm + mt * 16 + lane // 4 + 8 * (e // 2)
                                    col = wn + nt * 8 + lane % 4 * 2 + e % 2
                                    if m0 + row < M and n0 + col < N:
                                        out[s, m0 + row, n0 + col] = acc[row, col]
                                        owned[m0 + row, n0 + col] += s == 0
    assert (owned == 1).all()
    np.testing.assert_allclose(out.sum(0), a @ b, rtol=1e-12, atol=1e-12)


# (G, X, Y): the attention's narrow calls at Y = 33 (prefill and decode),
# dbrx's at Y = 260, a ragged Combine A, Y = 1, a long odd row, Y = 34 and 36
NARROW = [(128, 32, 33), (128, 1, 33), (192, 64, 260), (192, 1, 260), (3, 37, 53),
          (128, 64, 1), (8, 800, 1693), (2, 17, 34), (5, 9, 36), (1, 1024, 4097)]


@pytest.mark.parametrize("name", ["strassen", "laderman", "s555"])
@pytest.mark.parametrize("gxy", NARROW, ids=_ids)
def test_narrow_plan_fits(gxy, name):
    """The narrow route at every Y (odd ones included), both dtypes and a
    misaligned pointer: whole rows or even 16-byte column pieces that tile
    the plane, shared memory within budget, threads and grid within the
    launch limits."""
    G, X, Y = gxy
    coeff = talg.get(name).U
    R, d1, d2 = coeff.shape
    table = R + 1 + 2 * int(np.count_nonzero(coeff))
    for isz in (2, 4):
        for aligned in (True, False):
            p = tuning.plan_combine(G, X, Y, coeff, isz, aligned)
            if aligned and Y % (16 // isz) == 0:
                assert p.route == "vector"
                continue
            assert p.route == "narrow" and p.vec == 16 // isz
            assert 1 <= p.xb <= X and (p.yb == Y or (p.yb < Y and p.yb % p.vec == 0))
            assert 64 <= p.threads <= tuning.THREADS and p.threads & (p.threads - 1) == 0
            assert p.smem_bytes == tuning.combine_narrow_smem(d1 * d2, p.xb, p.yb, table, isz)
            assert p.smem_bytes <= tuning.SMEM_BUDGET
            assert -(-Y // p.yb) <= 65_535 and G <= 65_535
            assert p.blocks == -(-X // p.xb) * -(-Y // p.yb) * G


def _narrow_walk(x: np.ndarray, coeff: np.ndarray, p, out_shift: int) -> np.ndarray:
    """group_combine_narrow_kernel in numpy: each block stages its pieces,
    then writes every rank's runs chunk by chunk on the output's 16-byte grid
    (the output placed ``out_shift`` elements past a 16-byte boundary),
    masking a chunk's elements outside the run. Fails on an element written
    twice, one never written, or a full chunk off the grid."""
    G, rows, cols = x.shape
    R, d1, d2 = coeff.shape
    X, Y = rows // d1, cols // d2
    V = p.vec
    flat = np.full(out_shift + G * R * X * Y, np.nan)
    written = np.zeros(flat.shape, int)
    for g in range(G):
        for x0 in range(0, X, p.xb):
            for y0 in range(0, Y, p.yb):
                nx, ny = min(p.xb, X - x0), min(p.yb, Y - y0)
                piece = np.stack([x[g, i * X + x0:i * X + x0 + nx, l * Y + y0:l * Y + y0 + ny]
                                  .reshape(-1) for i in range(d1) for l in range(d2)])
                whole = ny == Y
                runs, run_len = (1, nx * ny) if whole else (nx, ny)
                for r in range(R):
                    w = sum(coeff[r].reshape(-1)[q] * piece[q] for q in range(d1 * d2))
                    for xr in range(runs):
                        a0 = out_shift + (g * R + r) * X * Y + (x0 + xr) * Y + y0
                        for ci in range(run_len // V + 2):
                            c0 = (a0 // V + ci) * V
                            off = c0 - a0
                            if off >= run_len:
                                continue
                            full = off >= 0 and off + V <= run_len
                            assert not full or c0 % V == 0
                            for j in range(V):
                                if 0 <= off + j < run_len:
                                    flat[c0 + j] = w[xr * ny + off + j]
                                    written[c0 + j] += 1
    assert (written[out_shift:] == 1).all()
    return flat[out_shift:].reshape(G, R, X, Y)


@pytest.mark.parametrize("name", ["strassen", "s555"])
@pytest.mark.parametrize("gxy", [(3, 37, 53), (2, 5, 1), (4, 6, 260), (1, 3, 4097), (2, 17, 34)],
                         ids=_ids)
def test_narrow_plan_walk_gives_the_plain_result(gxy, name, rng):
    """Walk the narrow plan (its pieces, ranks, runs and 16-byte chunks) at
    an aligned output and at one three elements off the grid: every output
    written once, equal to the plain Group Combine."""
    G, X, Y = gxy
    coeff = talg.get(name).U
    R, d1, d2 = coeff.shape
    x = rng.standard_normal((G, d1 * X, d2 * Y))
    want = np.einsum("ril,gixly->grxy", coeff, x.reshape(G, d1, X, d2, Y))
    for isz in (2, 4):
        p = tuning.plan_combine(G, X, Y, coeff, isz, aligned=False)
        for shift in (0, 3 % p.vec):
            np.testing.assert_allclose(_narrow_walk(x, coeff, p, shift), want, rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(24, 37, 40), (24, 37, 41), (9, 23, 17)], ids=_ids)
def test_matmul_matches_pallas(mkn, dtype, rng):
    """ops.matmul (the f32 route's shapes: K % 4 != 0; the mma route's: K
    and N odd) against the reference's matmul_pallas in interpret mode."""
    M, K_, N = mkn
    a, b = rng.standard_normal((M, K_)), rng.standard_normal((K_, N))
    want = jops.matmul_pallas(jnp.asarray(a, dtype), jnp.asarray(b, dtype), interpret=True)
    got = K.matmul(torch.tensor(a).to(getattr(torch, dtype)),
                   torch.tensor(b).to(getattr(torch, dtype)))
    assert tuple(got.shape) == want.shape and got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Y", [33, 34, 36])
@pytest.mark.parametrize("grouped", [False, True], ids=["2d", "batched"])
def test_narrow_group_combine_matches_pallas(grouped, Y, dtype, rng):
    """Group Combine at Y = 33, 34 and 36 (the narrow route in bf16 at all
    three, in f32 at 33 and 34) against the reference's Pallas kernels in
    interpret mode."""
    jl, tl = jalg.get("strassen"), talg.get("strassen")
    X = 8
    x = rng.standard_normal(((3,) if grouped else ()) + (jl.m * X, jl.k * Y))
    xj, xt = jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))
    if grouped:
        want = j_bcombine(xj, jl.U, block=(X, Y), interpret=True)
        got = K.batched_group_combine(xt, tl.U)
    else:
        want = j_combine(xj, jl.U, block=(X, Y), interpret=True)
        got = K.group_combine(xt, tl.U)
    isz = 4 if dtype == "float32" else 2
    assert tuning.plan_combine(3 if grouped else 1, X, Y, tl.U, isz).route == (
        "vector" if Y % (16 // isz) == 0 else "narrow")
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])
