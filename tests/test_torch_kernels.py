"""Port kernels vs the reference Pallas kernels (interpret mode), on the CPU.

On CPU tensors every kernel wrapper of ``repro_torch`` runs its plain
PyTorch version, the arithmetic the CUDA kernel implements: f32 sums
rounded once. The same numpy inputs go to the reference Pallas kernels in
interpret mode. Tolerances are the reference's own (``tests/test_kernels.py``):
f32 atol 1e-5 (same sums, another order), bf16 atol 6e-2 / rtol 2e-2 (the
Pallas kernels add in bf16, the port in f32, so >= 3-term sums can differ in
the last bf16 bit). The CUDA kernels themselves run only on the card: the
``cuda`` tests of ``test_torch_serve.py`` skip here, and ``chip_smoke.py``
holds every kernel to its plain version there.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core.falcon_gemm import precombine_weights as j_pre
from repro.kernels import ops as jops
from repro.kernels.fused_gemm import (batched_fused_gemm_combine_h as j_bfused,
                                      fused_gemm_combine_h as j_fused)
from repro.kernels.group_combine import (batched_group_combine as j_bcombine,
                                         group_combine as j_combine)
from repro_torch import kernels as K
from repro_torch.core import algorithms as talg
from repro_torch.core.falcon_gemm import precombine_weights as t_pre
from repro_torch.core.lcma import LCMA
from repro_torch.kernels import build, ref, tuning
from repro_torch.kernels.group_combine import coeff_table, launch_plan

from _schemes import mag2_111, mag2_scheme

SCHEMES = ["strassen", "s223", "mag2"]      # laderman: see the bf16 ops test
TOL = {"float32": dict(atol=1e-5, rtol=1e-6),
       "bfloat16": dict(atol=6e-2, rtol=2e-2)}
# f32 products: K-length dot products in another order (the reference's
# test_fused_gemm_blocks bound)
FUSED_F32 = dict(atol=1e-4, rtol=1e-5)


def _schemes(name):
    """(reference LCMA, port LCMA) with identical coefficients."""
    if name == "mag2":
        jl, j111 = mag2_scheme(), mag2_111()
        t111 = LCMA(j111.name, 1, 1, 1, 2, j111.U, j111.V, j111.W)
        tl = talg.tensor_product(t111, talg.strassen(), "mag2-222")
    else:
        jl, tl = jalg.get(name), talg.get(name)
    assert jl.fingerprint == tl.fingerprint
    return jl, tl


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_library_matches_reference():
    jlib, tlib = jalg.library(), talg.library()
    assert sorted(jlib) == sorted(tlib) and len(tlib) == 23
    for name in tlib:
        assert jlib[name].fingerprint == tlib[name].fingerprint, name
    assert [l.name for l in talg.candidates()] == [l.name for l in jalg.candidates()]


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouped", [False, True])
def test_group_combine_matches_pallas(name, dtype, grouped, rng):
    jl, tl = _schemes(name)
    X, Y = 32, 16
    x = rng.standard_normal(((3,) if grouped else ()) + (jl.m * X, jl.k * Y))
    xj, xt = _pair(x, dtype)
    if grouped:
        want = j_bcombine(xj, jl.U, block=(16, 8), interpret=True)
        got = K.batched_group_combine(xt, tl.U)
    else:
        want = j_combine(xj, jl.U, block=(16, 8), interpret=True)
        got = K.group_combine(xt, tl.U)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    _close(got, want, **TOL[dtype])


def test_group_combine_honors_coefficient_magnitude(rng):
    """|c| = 2, 3 coefficients are scaled, not sign-only: exact on integers."""
    jl, tl = _schemes("mag2")
    x = rng.integers(-4, 4, (jl.m * 16, jl.k * 16)).astype(np.float32)
    want = j_combine(jnp.asarray(x), jl.U, block=(8, 8), interpret=True)
    np.testing.assert_array_equal(K.group_combine(torch.tensor(x), tl.U).numpy(),
                                  np.asarray(want))
    A = rng.integers(-3, 3, (24, 20)).astype(np.float32)
    B = rng.integers(-3, 3, (20, 28)).astype(np.float32)
    np.testing.assert_array_equal(
        K.falcon_matmul(torch.tensor(A), torch.tensor(B), tl).numpy(),
        A.astype(np.float64) @ B.astype(np.float64))


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt_kind", ["2d", "per_group", "shared"])
def test_fused_gemm_matches_pallas(name, dtype, bt_kind, rng):
    jl, tl = _schemes(name)
    R = jl.R
    if bt_kind == "2d":
        at = rng.standard_normal((R, 32, 32))
        bt = rng.standard_normal((R, 32, 24))
    else:
        at = rng.standard_normal((2, R, 16, 32))
        bt = rng.standard_normal(((2,) if bt_kind == "per_group" else ()) + (R, 32, 24))
    (atj, att), (btj, btt) = _pair(at, dtype), _pair(bt, dtype)
    if bt_kind == "2d":
        want = j_fused(atj, btj, jl.W, block=(16, 24, 32), interpret=True)
        got = K.fused_gemm_combine_h(att, btt, tl.W)
    else:
        want = j_bfused(atj, btj, jl.W, block=(16, 24, 32), interpret=True)
        got = K.batched_fused_gemm_combine_h(att, btt, tl.W)
    assert tuple(got.shape) == want.shape
    _close(got, want, **(FUSED_F32 if dtype == "float32" else TOL[dtype]))


def test_fused_gemm_keeps_h_in_f32(rng):
    """bf16 operands, f32 output: C comes from f32 accumulators."""
    jl, tl = _schemes("strassen")
    at = rng.standard_normal((7, 16, 128)) * 30
    bt = rng.standard_normal((7, 128, 16)) * 30
    (atj, att), (btj, btt) = _pair(at, "bfloat16"), _pair(bt, "bfloat16")
    want = j_fused(atj, btj, jl.W, block=(16, 16, 64), out_dtype=jnp.float32,
                   interpret=True)
    got = K.fused_gemm_combine_h(att, btt, tl.W, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-4, atol=0.5)


OPS_FNS = ["matmul", "precombined", "grouped", "grouped_shared",
           "grouped_precombined", "grouped_precombined_stacked"]
M_, K_, N_, G_ = 13, 23, 17, 3       # ragged for every grid of the library


def _port_ops(fn, tl, a2, b2, a3, b3):
    if fn == "matmul":
        return K.falcon_matmul(a2, b2, tl)
    if fn == "precombined":
        return K.falcon_matmul_precombined(a2, t_pre(b2, tl), tl, N_)
    if fn == "grouped":
        return K.falcon_grouped_matmul(a3, b3, tl)
    if fn == "grouped_shared":
        return K.falcon_grouped_matmul(a3, b2, tl)
    if fn == "grouped_precombined":
        return K.falcon_grouped_matmul_precombined(a3, t_pre(b2, tl), tl, N_)
    return K.falcon_grouped_matmul_precombined(a3, t_pre(b3, tl), tl, N_)


def _pallas_ops(fn, jl, a2, b2, a3, b3):
    if fn == "matmul":
        return jops.falcon_matmul_pallas(a2, b2, jl, interpret=True)
    if fn == "precombined":
        return jops.falcon_matmul_pallas_precombined(a2, j_pre(b2, jl), jl, N_,
                                                     interpret=True)
    if fn == "grouped":
        return jops.falcon_grouped_matmul_pallas(a3, b3, jl, interpret=True)
    if fn == "grouped_shared":
        return jops.falcon_grouped_matmul_pallas(a3, b2, jl, interpret=True)
    bt = j_pre(b2, jl) if fn == "grouped_precombined" else \
        jax.vmap(lambda w: j_pre(w, jl))(b3)
    return jops.falcon_grouped_matmul_pallas_precombined(a3, bt, jl, N_,
                                                         interpret=True)


def _ops_inputs(rng, dtype):
    return [_pair(x, dtype) for x in (
        rng.standard_normal((M_, K_)), rng.standard_normal((K_, N_)),
        rng.standard_normal((G_, M_, K_)), rng.standard_normal((G_, K_, N_)))]


@pytest.mark.parametrize("fn", OPS_FNS)
def test_ops_match_pallas_pipeline(fn, rng):
    """The four ops pipelines at ragged shapes (padding + reassembly), f32,
    against the reference's Pallas pipeline in interpret mode (strassen, the
    served scheme; |c| > 1 through the whole pipeline is checked exactly in
    test_group_combine_honors_coefficient_magnitude)."""
    jl, tl = _schemes("strassen")
    pairs = _ops_inputs(rng, "float32")
    want = _pallas_ops(fn, jl, *(j for j, _ in pairs))
    got = _port_ops(fn, tl, *(t for _, t in pairs))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["strassen", "laderman", "mag2"])
@pytest.mark.parametrize("fn", OPS_FNS)
def test_ops_bf16_within_stability_bound(name, fn, rng):
    """bf16 ops pipelines against the exact product of the bf16 inputs.

    The reference's bf16 pipeline rounds the combined operands differently
    (its combines add in bf16, the port's in f32) and the GEMM and Combine H
    amplify that, so the two are each held to the scheme's static Higham
    bound (the stability pass: growth * terms * u * max|A| * max|B| * K).
    """
    _, tl = _schemes(name)
    (_, a2), (_, b2), (_, a3), (_, b3) = _ops_inputs(rng, "bfloat16")
    got = _port_ops(fn, tl, a2, b2, a3, b3)
    assert got.dtype == torch.bfloat16
    a = (a3 if fn.startswith("grouped") else a2).double()
    b = (b3 if fn in ("grouped", "grouped_precombined_stacked") else b2).double()
    exact = a @ b
    bound = tl.stability.error_bound("bfloat16") * a.abs().max() * b.abs().max() * K_
    assert (got.double() - exact).abs().max() <= bound


def test_ref_matches_float64_matmul(rng):
    """The plain end-to-end versions compute the product (grid-divisible)."""
    tl = talg.get("laderman")
    a, b = rng.standard_normal((2, 9, 12)), rng.standard_normal((12, 6))
    got = ref.grouped_lcma_matmul_ref(torch.tensor(a), torch.tensor(b), tl)
    np.testing.assert_allclose(got.numpy(), a @ b, atol=1e-4)
    c = ref.tiled_matmul_ref(torch.tensor(a[0]).bfloat16(), torch.tensor(b).bfloat16())
    assert c.dtype == torch.bfloat16
    np.testing.assert_allclose(c.float().numpy(), a[0] @ b, atol=0.1, rtol=0.02)
    with pytest.raises(ValueError):
        ref.lcma_matmul_ref(torch.zeros(10, 12), torch.zeros(12, 6), tl)


@pytest.mark.parametrize("name", ["strassen", "laderman", "s555", "mag2"])
def test_coeff_table_is_csr_of_the_scheme(name):
    _, tl = _schemes(name)
    for coeff in (tl.U, tl.V, tl.W):
        tab = coeff_table(coeff, torch.device("cpu")).numpy()
        R = coeff.shape[0]
        row_ptr = tab[:R + 1]
        nnz = row_ptr[-1]
        part, c = tab[R + 1:R + 1 + nnz], tab[R + 1 + nnz:]
        assert len(c) == nnz == np.count_nonzero(coeff)
        dense = np.zeros((R, coeff.shape[1] * coeff.shape[2]), np.int64)
        for r in range(R):
            for t in range(row_ptr[r], row_ptr[r + 1]):
                dense[r, part[t]] = c[t]
        np.testing.assert_array_equal(dense.reshape(coeff.shape), coeff)
        assert coeff_table(coeff, torch.device("cpu")) is coeff_table(
            coeff.copy(), torch.device("cpu"))


def test_planner_fits_every_candidate():
    """Every scheme of candidates(max_grid=5), up to s555, gets a tile that
    fits the shared-memory and register budgets, for prefill and decode
    rows: the f32 plan, and the bf16 and int8 tensor-core plans."""
    for l in talg.candidates(max_grid=5):
        for X in (2, 16, 17, 128, 1024):
            p = tuning.plan_fused_f32(1, X, 1024, 1024, l.R, l.m, l.n)
            assert (p.bx, p.bz, p.tm) in tuning.F32_TILES
            assert p.bk == tuning.fused_f32_bk(1024, p.pair)
            assert p.smem_bytes == tuning.fused_f32_smem(p.bx, p.bz, p.tm, p.bk, l.m * l.n,
                                                         l.R)
            assert p.smem_bytes <= tuning.SMEM_BUDGET
            regs = tuning.fused_f32_regs(p.tm, l.m * l.n)
            assert regs <= tuning.REGS_PER_THREAD and regs * p.threads <= tuning.REGS_PER_SM
            for by in (None, 128):
                p = tuning.plan_fused_tc(1, X, 1024, 1024, l.R, l.m, l.n, by=by)
                assert (p.bx, p.bz) in tuning.TC_TILES
                assert (p.bk, p.stages) == (tuning.TC_BK, tuning.TC_STAGES)
                assert p.acc_in_regs == (l.m * l.n <= tuning.TC_ACC_REGS)
                assert p.smem_bytes == tuning.fused_tc_smem(p.bx, p.bz, l.m * l.n,
                                                             by is not None)
                assert p.smem_bytes <= tuning.SMEM_BUDGET
                assert tuning.fused_tc_regs(p.bx, p.bz, l.m * l.n, by is not None) \
                    <= tuning.REGS_PER_THREAD
        for coeff in (l.U, l.V):
            nparts = coeff.shape[1] * coeff.shape[2]
            table_len = coeff_table(coeff, torch.device("cpu")).numel()
            for G, X, Y in ((1, 2, 1024), (1, 17, 40), (1, 1024, 24704), (128, 32, 32),
                            (3, 5, 1)):
                for isz in (2, 4):
                    p = tuning.plan_combine(G, X, Y, coeff, isz)
                    assert p.vec == 16 // isz
                    assert p.route == ("vector" if Y % (16 // isz) == 0 else "narrow")
                    assert 1 <= p.threads <= tuning.THREADS and p.rows in (1, 2, 4, 8)
                    assert p.smem_bytes == (
                        tuning.combine_smem(nparts, p.threads, table_len, 16)
                        if p.route == "vector" else
                        tuning.combine_narrow_smem(nparts, p.xb, p.yb, table_len, isz))
                    assert p.smem_bytes <= tuning.SMEM_BUDGET
                    regs = tuning.combine_regs(p.vec)
                    assert regs <= tuning.REGS_PER_THREAD
                    assert regs * p.threads <= tuning.REGS_PER_SM
    f32 = lambda X: tuning.plan_fused_f32(1, X, 1024, 4096, 7, 2, 2)  # noqa: E731
    assert (f32(2).bx, f32(128).bx) == (8, 64)                       # decode rows, prefill
    tc = lambda X: tuning.plan_fused_tc(1, X, 1024, 4096, 7, 2, 2)  # noqa: E731
    assert (tc(2).bx, tc(16).bx, tc(17).bx, tc(128).bx) == (8, 16, 32, 32)
    assert tc(128).splits == 1 and tc(2).splits > 1        # mlp_up: prefill, decode
    # the tiled GEMM's f32 and mma routes (f32, unaligned bf16)
    for M, N in ((4, 8192), (13, 17), (256, 2048), (256, 8192), (4096, 4096)):
        p = tuning.plan_tiled_f32(M, 2048, N)
        assert (p.bm, p.bn) in tuning.TILED_F32_TILES and p.bk == tuning.TILED_F32_BK
        assert p.smem_bytes == tuning.tiled_f32_smem(p.bm, p.bn) <= tuning.SMEM_BUDGET
        assert p.regs <= tuning.REGS_PER_THREAD
        q = tuning.plan_tiled_mma(M, 2048, N)
        assert (q.bm, q.bn) in tuning.TILED_MMA_TILES and q.bk == tuning.TILED_MMA_BK
        assert q.smem_bytes == tuning.tiled_mma_smem(q.bm) <= tuning.SMEM_BUDGET
    assert tuning.plan_tiled_f32(4, 2048, 8192).bm == 8                 # decode rows
    assert tuning.plan_tiled_f32(256, 2048, 8192).splits > 1            # fills the card
    assert (tuning.plan_tiled_f32(4096, 4096, 4096).bm,
            tuning.plan_tiled_f32(4096, 4096, 4096).bn) == (128, 256)
    # its tensor-core route (aligned bf16)
    wg = tuning.plan_tiled_wgmma
    assert (wg(4096, 4096, 4096).bm, wg(4096, 4096, 4096).bn) == (128, 256)
    assert wg(4096, 4096, 4096).splits == 1
    assert (wg(256, 2048, 8192).bm, wg(256, 2048, 8192).bn) == (128, 128)   # probe 1
    assert wg(256, 2048, 8192).splits == 1 and wg(256, 2048, 8192).blocks >= 128
    assert wg(4, 2048, 8192).bm == 64 and wg(4, 2048, 8192).splits > 1       # decode rows


# (M, K, N): the tune probes, decode rows, ragged and tiny aligned shapes
WG_SHAPES = [(4096, 4096, 4096), (256, 2048, 8192), (256, 8192, 2048), (4, 2048, 8192),
             (4, 8192, 2048), (128, 64, 128), (200, 136, 264), (1, 8, 8), (65, 512, 520),
             (4096, 2048, 512)]


@pytest.mark.parametrize("mkn", WG_SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_tiled_wgmma_plan_fits_and_fills_the_card(mkn):
    """The tensor-core tiled-GEMM plan is a tile the source instantiates,
    fits shared memory and registers (with as many blocks an SM as its
    shared memory allows), and reaches TILED_MIN_BLOCKS blocks or is split
    as far as the resident blocks, the K stages and the partials' bytes
    allow; the K ranges of a split cover every 64-deep stage once."""
    M, K_, N = mkn
    p = tuning.plan_tiled_wgmma(M, K_, N)
    assert (p.bm, p.bn) in tuning.TILED_WG_TILES
    assert (p.bk, p.stages) == (tuning.TILED_WG_BK, tuning.TILED_WG_STAGES)
    assert p.smem_bytes == tuning.tiled_wgmma_smem(p.bm, p.bn) <= tuning.SMEM_BUDGET
    assert p.threads == tuning.tiled_wgmma_threads(p.bm) == p.bm // 64 * 128 + 32
    per_sm = tuning.SMEM_PER_SM // (p.smem_bytes + 1024)
    regs = tuning.tiled_wgmma_regs(p.bn)
    assert per_sm >= 1 and regs <= tuning.REGS_PER_THREAD
    assert regs * p.threads * per_sm <= tuning.REGS_PER_SM
    assert p.tiles == -(-M // p.bm) * -(-N // p.bn)
    kblocks = -(-K_ // tuning.TILED_WG_BK)
    if p.tiles >= tuning.TILED_MIN_BLOCKS:
        assert p.splits == 1
    else:
        assert p.blocks <= tuning.SMS * per_sm or p.splits == 1
        assert p.splits == 1 or kblocks // p.splits >= tuning.TILED_WG_MIN_KBLOCKS
        assert p.splits == 1 or 4 * M * N * p.splits <= 2 * (M * K_ + K_ * N)
    # the kernel's K range of split s: [kblocks * s // S, kblocks * (s + 1) // S)
    ranges = [(kblocks * s // p.splits, kblocks * (s + 1) // p.splits)
              for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == kblocks
    assert all(b0 < b1 for b0, b1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_tiled_wgmma_splits_the_second_probe():
    """256x8192x2048 has 32 output tiles of 128 x 128 for 132 SMs: the K
    range is split so the grid reaches TILED_MIN_BLOCKS."""
    p = tuning.plan_tiled_wgmma(256, 8192, 2048)
    assert p.tiles == 32 and p.splits > 1 and p.blocks >= tuning.TILED_MIN_BLOCKS


@pytest.mark.parametrize("dtype,K,N,a_ptr,b_ptr,route", [
    ("bfloat16", 2048, 8192, 0, 1024, "wgmma"),     # the probes, decode rows
    ("bfloat16", 64, 128, 16, 4096, "wgmma"),
    ("float32", 2048, 8192, 0, 1024, "f32"),        # TF32 would break 1e-4
    ("bfloat16", 23, 17, 0, 1024, "mma"),           # K, N: row strides not 16 bytes
    ("bfloat16", 2048, 8196, 0, 1024, "mma"),
    ("bfloat16", 101, 72, 0, 1024, "mma"),
    ("bfloat16", 512, 384, 2, 1026, "mma"),         # chip_smoke's misaligned case
    ("bfloat16", 512, 384, 0, 1026, "mma"),
])
def test_tiled_route_rule(dtype, K, N, a_ptr, b_ptr, route):
    """Aligned bf16 goes to wgmma; bf16 that TMA cannot address to the
    mma.sync route; f32 to the FP32 SGEMM, decided before the launch."""
    assert tuning.tiled_route(dtype, K, N, a_ptr, b_ptr) == route


@pytest.mark.parametrize("G,X,Y,isz,aligned,route", [
    (1, 1024, 24704, 2, True, "vector"),      # the LM head's Combine B
    (1, 1024, 24704, 4, True, "vector"),
    (128, 32, 32, 2, True, "vector"),         # the attention scores' Combine A
    (1, 2, 1024, 2, True, "vector"),          # mlp_up Combine A at decode
    (1, 37, 53, 2, True, "narrow"),           # Y no multiple of 8 bf16 ...
    (1, 37, 54, 4, True, "narrow"),           # ... or of 4 f32
    (1, 128, 1024, 2, False, "narrow"),       # a pointer not 16-byte aligned
])
def test_combine_plan_vector_width(G, X, Y, isz, aligned, route):
    """16-byte loads where Y and both pointers allow them, the narrow route
    otherwise (16-byte stores either way); the grid covers every (group,
    row, y vector) or every (group, row piece, column piece), and small
    vector calls are spread over at least SMS blocks where 64-thread blocks
    can."""
    p = tuning.plan_combine(G, X, Y, talg.get("strassen").U, isz, aligned)
    assert p.route == route and p.vec == 16 // isz
    if route == "narrow":
        assert (p.tx, p.rows) == (1, 1) and 64 <= p.threads <= tuning.THREADS
        assert p.blocks == -(-X // p.xb) * -(-Y // p.yb) * G
        assert p.yb == Y or p.yb % p.vec == 0
        return
    yv = Y // p.vec
    assert p.blocks == -(-yv // p.ty) * -(-X // (p.tx * p.rows)) * G
    assert p.ty * p.vec * -(-yv // p.ty) >= Y and p.tx * p.rows * -(-X // (p.tx * p.rows)) >= X
    assert p.blocks >= tuning.SMS or p.threads <= 64
    if p.rows > 1:
        assert p.blocks >= tuning.COMBINE_MIN_BLOCKS


@pytest.mark.parametrize("offset,route", [(0, "vector"), (1, "narrow")],
                         ids=["aligned", "misaligned"])
def test_launch_plan_reads_the_coefficients_and_the_pointers(offset, route):
    """The wrapper's plan comes from the scheme's coefficients and the
    operands' alignment: a view one element into its storage takes the
    narrow route, and an output that is misaligned does too."""
    U = talg.get("strassen").U
    x = torch.zeros(256 * 2048 + 8, dtype=torch.bfloat16)[offset:offset + 256 * 2048]
    x = x.view(256, 2048)
    p = launch_plan(x, U)
    assert p == tuning.plan_combine(1, 128, 1024, U, 2, aligned=offset == 0)
    assert p.route == route
    out = torch.zeros(8, dtype=torch.bfloat16)[1:]
    assert launch_plan(x, U, out).route == "narrow"


def test_combine_plan_shrinks_blocks_to_fit_shared_memory():
    """s555's 25 parts of 16 bytes for 256 threads and its table fit; a
    tight budget halves the block along x until the slots and the table
    fit."""
    U = talg.get("s555").U
    table = coeff_table(U, torch.device("cpu")).numel()
    p = tuning.plan_combine(1, 1024, 4096, U, 2)
    assert p.threads == 256 and p.smem_bytes == 25 * 256 * 16 + 4 * table
    q = tuning.plan_combine(1, 1024, 4096, U, 2, budget=60_000)
    assert q.threads < p.threads and q.smem_bytes <= 60_000
    with pytest.raises(ValueError):
        tuning.plan_combine(1, 1024, 4096, U, 2, budget=100)


# The quant Group Combine A's calls: Combine A of granite's int8 leaves (K =
# 2048: w_q, w_k, w_v, w_o, mlp_gate, mlp_up; K = 8192: mlp_down) at the
# prefill and decode M, and of the tune probes, as (M, K).
QC_CALLS = [(M, K_) for M in (256, 4) for K_ in (2048, 8192)] + [(256, 2048), (256, 8192),
                                                                 (4096, 4096)]
# chip_smoke.py's schemes
QC_SCHEMES = ["strassen", "strassen-winograd", "laderman", "s444", "s555", "mag2"]


def _port_scheme(name):
    return _schemes(name)[1] if name == "mag2" else talg.get(name)


def _check_quant_plan(p, X, Y, l, isz, by, aligned):
    """A quant Group Combine plan fits and covers its call: the route rule,
    the lanes of a K-block, the block, shared memory as the launcher
    computes it, registers, the grid and the rank split."""
    R, d1, d2 = l.U.shape
    table_len = coeff_table(l.U, torch.device("cpu")).numel()
    wide = 16 // isz
    assert p.route == ("vector" if aligned and by % wide == 0 else "scalar")
    assert p.vec == (wide if p.route == "vector" else 1) and p.by == by
    nv = by // p.vec
    assert p.lanes == min(32, 1 << (nv - 1).bit_length())
    assert p.per_lane == -(-nv // p.lanes) and (p.per_lane == 1 or p.lanes == 32)
    assert p.threads % 32 == 0 and 32 <= p.threads <= tuning.QUANT_COMBINE_THREADS
    assert p.units == p.threads // p.lanes
    assert p.smem_bytes == tuning.quant_combine_smem(d1 * d2, p.per_lane, p.threads, table_len,
                                                     p.vec * isz)
    assert p.smem_bytes == tuning.combine_smem(d1 * d2 * p.per_lane, p.threads, table_len,
                                               p.vec * isz) <= tuning.SMEM_BUDGET
    regs = tuning.quant_combine_regs(p.vec)
    assert regs <= tuning.REGS_PER_THREAD and regs * p.threads <= tuning.REGS_PER_SM
    grid = -(-X * (Y // by) // p.units)
    assert p.blocks == grid * p.splits and 1 <= p.splits <= R
    if grid >= tuning.QUANT_SPLIT_MIN_BLOCKS:
        assert p.splits == 1
    else:
        assert p.splits == min(R, -(-tuning.QUANT_SPLIT_MIN_BLOCKS // grid))
    assert grid >= tuning.SMS or p.threads <= 64


@pytest.mark.parametrize("name", QC_SCHEMES)
def test_quant_combine_plan_fits_every_call(name):
    """Every scheme chip_smoke.py checks, at every Combine A call of
    granite's int8 leaves and of the tune probes (their K-block from
    ``scale_block``) and at K-blocks of 1, 25, 96 and 128, in both dtypes,
    aligned or not: the plan fits and takes the expected route."""
    l = _port_scheme(name)
    calls = [(-(-M // l.m), K_ // l.k) for M, K_ in QC_CALLS]
    calls = [(X, Y, tuning.scale_block(Y)) for X, Y in calls]
    calls += [(X, 2400, by) for X in (2, 128) for by in (1, 25, 96)]
    calls += [(X, 1024, 128) for X in (2, 128)]
    for X, Y, by in calls:
        for isz in (2, 4):
            for aligned in (True, False):
                p = tuning.plan_quant_combine(X, Y, l.U, isz, by, aligned)
                _check_quant_plan(p, X, Y, l, isz, by, aligned)


@pytest.mark.parametrize("by,isz,aligned,route,lanes", [
    (128, 2, True, "vector", 16),      # granite's K-block, bf16: 16 lanes of 8
    (128, 4, True, "vector", 32),      # f32: 32 lanes of 4
    (96, 2, True, "vector", 16),       # 12 lanes, padded to 16
    (96, 4, True, "vector", 32),       # 24 lanes, padded to 32
    (128, 2, False, "scalar", 32),     # a pointer not 16-byte aligned: 4 columns a lane
    (25, 2, True, "scalar", 32),       # chip_smoke's ragged case
    (25, 4, True, "scalar", 32),
    (1, 2, True, "scalar", 1),         # laderman at scale_block(683) = 1
    (4, 2, True, "scalar", 4),
    (4, 4, True, "vector", 1),
])
def test_quant_combine_route_rule(by, isz, aligned, route, lanes):
    """The vector route exactly where ``by`` is a multiple of 16 bytes of
    elements and the input is 16-byte aligned, decided before the launch."""
    p = tuning.plan_quant_combine(128, by * 8, talg.get("strassen").U, isz, by, aligned)
    assert (p.route, p.lanes) == (route, lanes)


def test_quant_combine_plan_splits_ranks_at_decode():
    """mlp_up's Combine A at decode (X = 2: 16 K-blocks for 132 SMs) splits
    the ranks across blocks, one rank each under strassen and s444; at
    prefill (256 blocks of 64 threads) into 4 rank groups; the 4096^2 probe
    runs one block per 16 K-blocks, unsplit."""
    U = talg.get("strassen").U
    dec = tuning.plan_quant_combine(2, 1024, U, 2, 128)
    assert (dec.route, dec.lanes, dec.threads, dec.splits) == ("vector", 16, 64, 7)
    s444 = talg.get("s444")
    assert tuning.plan_quant_combine(2, 512, s444.U, 2, 128).splits == s444.R
    pre = tuning.plan_quant_combine(128, 1024, U, 2, 128)
    assert (pre.threads, pre.splits, pre.blocks) == (64, 4, 1024)
    probe = tuning.plan_quant_combine(2048, 2048, U, 2, 128)
    assert (probe.threads, probe.units, probe.splits, probe.blocks) == (256, 16, 1, 2048)
    with pytest.raises(ValueError, match="does not divide"):
        tuning.plan_quant_combine(2, 100, U, 2, 128)


def test_quant_launch_plan_reads_the_pointer():
    """The wrapper's plan: the vector route for an aligned input, the
    scalar one for a view one element into its storage."""
    from repro_torch.kernels.quant_combine import launch_plan as quant_launch_plan
    U = talg.get("strassen").U
    for offset, route in ((0, "vector"), (1, "scalar")):
        x = torch.zeros(256 * 2048 + 8, dtype=torch.bfloat16)[offset:offset + 256 * 2048]
        p = quant_launch_plan(x.view(256, 2048), U, 128)
        assert p == tuning.plan_quant_combine(128, 1024, U, 2, 128, aligned=offset == 0)
        assert p.route == route


def _quant_fast_quotient(acc, s, y):
    """The kernel's quotient (csrc/quant_combine.cu:quantize) in numpy f32:
    p = RN(acc * y), t = RN(p + 1.5 * 2^23), n = t - 1.5 * 2^23, and whether
    p lies within 2^-14 of a half-integer (then the kernel divides)."""
    f = np.float32
    M = f(12582912.0)
    p = (acc * y).astype(f)
    t = (p + M).astype(f)
    n = (t - M).astype(f)
    near = np.abs((p - n).astype(f)) >= f(0.5) - f(2.0 ** -14)
    return t, n, near


@pytest.mark.parametrize("kind", ["normal", "ties", "tiny"])
def test_quant_fast_quotient_rounds_as_the_division(kind):
    """Wherever the kernel keeps its product with an approximate reciprocal
    (any y within one ulp of 1/s, as rcp.approx gives), the integer it
    takes is rint(RN(acc / s)), the reference's, and its word's low byte is
    that integer's; the values it sends to the division are few. Random
    sums, sums on exact rounding ties (s a power of two) and sums so small
    that s is the 1e-12 floor."""
    f = np.float32
    rng = np.random.default_rng(16)
    acc = rng.standard_normal((4096, 128)).astype(f)
    if kind == "ties":
        acc = (rng.integers(-254, 255, acc.shape) / f(2)).astype(f)
        acc[:, 0] = f(127)
    elif kind == "tiny":
        acc = (acc * f(1e-11)).astype(f)
    amax = np.abs(acc).max(axis=1, keepdims=True)
    s = np.maximum((amax * (f(1) / f(127))).astype(f), f(1e-12)).astype(f)
    want = np.rint((acc / s).astype(f))
    assert np.abs(want).max() <= 127                  # the clip never binds
    y0 = (f(1) / s).astype(f)
    sent = 0
    for y in (y0, np.nextafter(y0, f(np.inf)), np.nextafter(y0, f(0))):
        t, n, near = _quant_fast_quotient(acc, s, y)
        np.testing.assert_array_equal(n[~near], want[~near])
        low = (t.view(np.int32) & 0xFF).astype(np.int8)
        np.testing.assert_array_equal(low[~near], want[~near].astype(np.int8))
        sent = max(sent, int(near.sum()))
    if kind == "ties":
        assert sent > 0                               # ties do take the division
    else:
        assert sent <= acc.size // 1000


def test_block_plans_export_the_quant_combine_plan():
    l = talg.get("strassen")
    bp = tuning.block_plans(l, 4096, 4096, 4096, dtype="bfloat16")
    want = tuning.plan_quant_combine(2048, 2048, l.U, 2, 128)
    assert bp["quant_combine_a"] == want.as_dict()
    assert bp["quant_combine_a"]["route"] == "vector"
    assert bp["quant_combine_a_smem_bytes"] == want.smem_bytes


def test_kernel_sources_agree_with_planner():
    """The tile shapes, stage depths and block sizes the planner assumes are
    the ones csrc/fused_gemm.cu (f32), csrc/fused_tc.cuh (bf16 and int8
    tensor cores), csrc/tiled_matmul.cu (both routes) and
    csrc/group_combine.cu instantiate."""
    src = (build.CSRC / "fused_gemm.cu").read_text()
    tiles = re.findall(r"if \(bx == (\d+) && bz == (\d+)\) return launch_acc<(\d+), "
                       r"(\d+), (\d+), BK>", src)
    assert all((a, b) == (c, d) for a, b, c, d, _ in tiles)
    assert set((int(a), int(b), int(t)) for a, b, _, _, t in tiles) == set(tuning.F32_TILES)
    assert set(int(b) for b in re.findall(r"if \(bk == (\d+)\) return launch_bk<(?:\d+)>",
                                           src)) == set(tuning.F32_BKS)
    assert f"kTN = {tuning.F32_TN};" in src
    assert f"kStages = {tuning.F32_STAGES};" in src
    assert f"kPadA = {tuning.F32_PAD};" in src and f"kPadB = {tuning.F32_PAD_B};" in src
    assert set(int(b) for b in re.findall(r"if \(bk == (\d+)\)", src)) == set(tuning.F32_BKS)
    assert "kRing = kStages * (kStageA + kStageB);" in src.split("struct PairTile")[1]
    assert "kStageA = BX * kRowA, kStageB = BK * kRowB;" in src
    assert "kRowA = BK + kPadA;" in src and "kRowB = BZ + kPadB;" in src
    assert "static size_t bytes(int R) { return 4 * ((size_t)kRing + (size_t)kAccRegs * R); }" \
        in src
    assert "kThreads = 2 * kPX * kPZ;" in src and "kPX = BX / 8, kPZ = BZ / 8;" in src
    assert f"kAccRegs = {tuning.F32_ACC_REGS};" in src
    assert "kRing = kStages * (kStageA + kStageB);" in src
    assert "kStageA = BX * kRowA;" in src and "kRowA = BK + kPadA;" in src
    assert "kStageB = BK * BZ;" in src and "kThreads = kNX * kNZ;" in src
    assert "return 4 * ((size_t)kRing + (acc_regs ? 0 : (size_t)mn * BX * BZ));" in src
    assert "if constexpr (TM == 8) {\n    if (p.mn <= kAccRegs) {\n      if constexpr (BK != 16) " \
        "{\n        using L = PairTile" in src        # the pair kernel: tm 8, m*n <= 4
    assert "if (p.mn <= kAccRegs)\n      return run(fused_f32_kernel<BX, BZ, TM, BK, true>" in src
    assert "smem != (size_t)p.smem_bytes" in src     # the launcher holds the planner's bytes
    body = src[src.index("namespace f32 {"):src.index("}  // namespace f32")]
    assert "fmaf(" in body and not re.search(r"mma|tf32|asm", body, re.I)  # FP32 FMAs only
    assert '#include "fused_tc.cuh"' in src
    assert '#include "fused_tc.cuh"' in (build.CSRC / "quant_combine.cu").read_text()
    src = (build.CSRC / "fused_tc.cuh").read_text()
    warps = {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in re.findall(
        r"if \(bx == (\d+) && bz == (\d+)\) return launch_acc<QUANT, Tout, \d+, \d+, "
        r"(\d+), (\d+)>", src)}
    assert warps == tuning.TC_WARPS and set(warps) == set(tuning.TC_TILES)
    assert f"kBK = {tuning.TC_BK};" in src
    assert f"kStages = {tuning.TC_STAGES};" in src
    assert f"kThreads = {tuning.TC_THREADS};" in src
    assert f"kPad = {tuning.TC_PAD};" in src
    assert f"kAccRegs = {tuning.TC_ACC_REGS};" in src
    assert "smem != (size_t)p.smem_bytes" in src     # the launcher holds the planner's bytes
    src = (build.CSRC / "tiled_matmul.cu").read_text()
    # the f32 route: each tile of TILED_F32_TILES launched with its warp and
    # lane layout and launch bounds; ring depth, stage depth and padding
    tiles = {(int(a), int(b)): tuple(int(v) for v in rest) for a, b, *rest in re.findall(
        r"if \(bm == (\d+) && bn == (\d+)\)\s+return launch<Tile<\1, \2, (\d+), (\d+), "
        r"(\d+), (\d+), (\d+)>, Tout>", src)}
    assert tiles == tuning.TILED_F32_TILES
    assert f"kBK = {tuning.TILED_F32_BK};      // TILED_F32_BK" in src
    assert f"kStages = {tuning.TILED_F32_STAGES};   // TILED_F32_STAGES" in src
    assert f"kPadA = {tuning.TILED_F32_PAD};" in src
    assert "kBytes = kStages * kStage * 4;" in src and "kLdA = BM + kPadA;" in src
    body = src[src.index("namespace sg {"):src.index("}  // namespace sg")]
    assert "fmaf(" in body and not re.search(r"mma|tf32|wgmma", body, re.I)  # FP32 FMAs only
    # the mma route: tiles, stage depth, ring depth, padding and launch bounds
    mm = src[src.index("namespace mm {"):src.index("}  // namespace mm")]
    assert set((int(b), 128) for b in re.findall(r"if \(bm == (\d+)\)\s+return launch<", mm)) \
        == set(tuning.TILED_MMA_TILES)
    assert f"kBK = {tuning.TILED_MMA_BK};" in mm and f"kStages = {tuning.TILED_MMA_STAGES};" in mm
    assert f"kPad = {tuning.TILED_MMA_PAD};" in mm
    assert f"kMinBlocks = {tuning.TILED_MMA_MIN_BLOCKS};" in mm
    assert "kBytes = (kStages + 1) * kStage * 2;" in mm and "mma.sync" not in mm  # via ftc::mma
    assert "ftc::mma(" in mm and '#include "fused_tc.cuh"' in src
    assert "falcon_tiled_matmul(" not in src      # the SIMT route is gone
    # the tensor-core route: the tiles TILED_WG_TILES names, each launched
    # with its own template arguments; ring depth, stage depth and layout
    wg = re.findall(r"if \(bm == (\d+) && bn == (\d+)\)\s+return launch_wgmma<Tout, (\d+), "
                    r"(\d+)>", src)
    assert all((a, b) == (c, d) for a, b, c, d in wg)
    assert set((int(a), int(b)) for a, b, _, _ in wg) == set(tuning.TILED_WG_TILES)
    assert f"kWgBK = {tuning.TILED_WG_BK};" in src
    assert f"kWgStages = {tuning.TILED_WG_STAGES};" in src
    assert "kBytes = 1024 + kWgStages * kStage + 2 * kWgStages * 8;" in src
    assert "kThreads = BM / 64 * 128 + 32;" in src
    assert "smem_bytes != L::kBytes" in src      # the launcher holds the planner's bytes
    assert '#include "wgmma_tma.cuh"' in src
    hdr = (build.CSRC / "wgmma_tma.cuh").read_text()
    widths = {int(n) for n in re.findall(r"wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16", hdr)}
    assert widths == {bn for _, bn in tuning.TILED_WG_TILES}
    # Group Combine: the vector widths the planner picks, the launcher's check
    src = (build.CSRC / "group_combine.cu").read_text()
    for dtype, isz in (("FALCON_F32", 4), ("FALCON_BF16", 2)):
        assert f"dtype == {dtype} && vec == {16 // isz}" in src
        assert f"dtype == {dtype} && vec == 1" not in src    # no scalar path left
    assert "smem != (size_t)smem_bytes" in src
    assert "return (slots + 15) / 16 * 16 + (size_t)table_len * 4;" in src
    # the narrow route: its layout as combine_narrow_smem computes it
    assert ("return 32 + (size_t)nparts * (((size_t)xb * yb + V - 1) / V * V) * sizeof(T) +\n"
            "         (size_t)table_len * 4;") in src
    assert "extern \"C\" int falcon_group_combine_narrow(" in src
    assert "struct Pack<__nv_bfloat16, 8>" in (build.CSRC / "common.cuh").read_text()
    # quant Group Combine A: block size, routes, the smem formula the
    # launcher holds the planner to, and the bit-exact arithmetic
    src = (build.CSRC / "quant_combine.cu").read_text()
    assert f"kQcThreads = {tuning.QUANT_COMBINE_THREADS};" in src
    for dtype, isz in (("FALCON_F32", 4), ("FALCON_BF16", 2)):
        assert f"dtype == {dtype} && vec == {16 // isz}" in src
        assert f"dtype == {dtype} && vec == 1" in src
    assert "(size_t)nparts * per_lane * threads * sizeof(typename Pack<T, VEC>::Raw);" in src
    assert "return (slots + 15) / 16 * 16 + (size_t)table_len * 4;" in src
    assert "if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;" in src
    assert "__fmul_rn(amax, 1.f / 127.f)" in src and "rintf(__fdiv_rn(acc[e], s))" in src
    assert "__fadd_rn(acc[e], __fmul_rn(cf, u[e]))" in src and "__fdividef" not in src
    assert "rcp.approx.ftz.f32" in src and ">= 0.5f - 0x1p-14f" in src   # _quant_fast_quotient
    assert "kRound = 12582912.f;" in src
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()


# The served model's logical products (M, K, N), as chip_smoke.py's PROJ:
# prefill M = 4 x 64 and decode M = 4; granite_3_2b's projections and the
# tied LM head (vocab 49155 padded to 49408).
GRANITE_PROJ = [(M, K, N) for M in (256, 4)
                for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                             (2048, 49408))]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mkn", GRANITE_PROJ, ids=lambda t: "x".join(map(str, t)))
def test_split_plan_fills_the_card_for_granite(mkn, quant):
    """Under strassen, every granite leaf at prefill and decode is planned
    to at least one block per SM, or its split is the largest the planner
    allows; the split only appears where the tiles alone do not fill it."""
    l = talg.get("strassen")
    M, K_, N = mkn
    X, Y, Z = -(-M // l.m), K_ // l.k, N // l.n
    p = tuning.plan_fused_tc(1, X, Y, Z, l.R, l.m, l.n,
                             by=tuning.scale_block(Y) if quant else None)
    assert p.blocks >= tuning.SMS or p.splits == p.split_max
    assert 1 <= p.splits <= p.split_max <= p.units
    if p.tiles >= tuning.SMS:
        assert p.splits == 1
    else:
        assert p.splits == min(-(-tuning.SPLIT_MIN_BLOCKS // p.tiles), p.split_max)


def _split_chunks(plan, Y, by):
    """For each split, the (rank, first K index) of every ring stage it runs,
    in order, as csrc/fused_tc.cuh walks the flattened sequence: unit u is
    (rank u // per_rank, K-block u % per_rank) of ``by`` columns (bf16: of
    TC_BK columns), cut into ``steps_per_unit`` stages."""
    unit_k = by or plan.bk
    per_rank = -(-Y // unit_k)
    return [[(u // per_rank, (u % per_rank) * unit_k + c * plan.bk)
             for u in range(b, e) for c in range(plan.steps_per_unit)]
            for b, e in tuning.split_ranges(plan.units, plan.splits)]


@pytest.mark.parametrize("shape", [(2, 1024, 4096, 128), (2, 1024, 256, 128),
                                   (37, 75, 45, 25), (3, 300, 40, 100), (1, 40, 32, None),
                                   (2, 4096, 1024, None), (19, 23, 21, None)])
@pytest.mark.parametrize("name", ["strassen", "laderman", "s555"])
def test_split_ranges_cover_every_chunk_once(name, shape):
    """The S unit ranges cover every (rank, K-chunk) step of the reduction
    exactly once and in order; int8 ranges start on K-block boundaries, so
    no int32 sum is cut."""
    l = talg.get(name)
    X, Y, Z, by = shape
    p = tuning.plan_fused_tc(1, X, Y, Z, l.R, l.m, l.n, by=by)
    ranges = tuning.split_ranges(p.units, p.splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    chunks = _split_chunks(p, Y, by)
    flat = [c for part in chunks for c in part]
    unit_k = by or tuning.TC_BK
    want = [(r, yb * unit_k + c * tuning.TC_BK) for r in range(l.R)
            for yb in range(-(-Y // unit_k)) for c in range(p.steps_per_unit)]
    assert flat == want
    assert all(len(part) > 0 for part in chunks)
    if by is not None:
        assert all(part[0][1] % by == 0 for part in chunks)


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    tl = talg.get("strassen")
    before = K.launch_counts()
    with pytest.raises(TypeError):
        K.group_combine(torch.zeros(4, 4, dtype=torch.float64), tl.U)
    with pytest.raises(ValueError):
        K.group_combine(torch.zeros(5, 4), tl.U)
    with pytest.raises(ValueError):
        K.fused_gemm_combine_h(torch.zeros(7, 4, 4), torch.zeros(7, 5, 4), tl.W)
    with pytest.raises(ValueError):
        K.batched_fused_gemm_combine_h(torch.zeros(2, 7, 4, 4),
                                       torch.zeros(3, 7, 4, 4), tl.W)
    c = K.falcon_matmul(torch.ones(5, 6), torch.ones(6, 7), tl)
    torch.testing.assert_close(c, torch.full((5, 7), 6.0))
    routes = dict(K.tiled_matmul.routes)
    K.tiled_matmul(torch.ones(8, 16, dtype=torch.bfloat16), torch.ones(16, 8, dtype=torch.bfloat16))
    qroutes = dict(K.group_combine_quant.routes)
    K.group_combine_quant(torch.ones(8, 16, dtype=torch.bfloat16), tl.U, 8)
    assert K.launch_counts() == before      # the CPU path launches nothing
    assert K.tiled_matmul.routes == routes  # ... on either route
    assert K.group_combine_quant.routes == qroutes
