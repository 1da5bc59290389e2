"""The f32 fused GEMM + Combine H kernel's planner (``tuning.plan_fused_f32``)
and the reduction it plans, on the CPU.

The kernel itself (``csrc/fused_gemm.cu``, namespace ``f32``) runs only on
the card, where ``chip_smoke.py`` holds it to its plain version. Here: every
scheme up to s555 gets a plan within an H100 block's shared memory (232,448
bytes) and 255 registers a thread at the shapes the main path gives it (the
SSD leaves of mamba2 and hymba, decode rows, the ragged kernel cases), the
plan takes the 32-wide tile, the 8-deep stage and the 8-row tile where the
shape calls for them, and the reduction the plan describes (the flattened
(rank, K-stage) steps, cut into splits, each rank folded into the output
accumulators in ascending order through the CSR table) gives the plain
version's result.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import plans as lint
from repro_torch.core import algorithms as talg
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import ref, tuning
from repro_torch.kernels.group_combine import coeff_table

# f32 products of K-length sums in another order (tests/test_torch_kernels.py)
FUSED_F32 = dict(atol=1e-4, rtol=1e-5)

# The SSD scan's four grouped contractions at the one-shot prefill (4 x 2048
# tokens, chunks of 256) as (G, M, K, N): scores, y_diag, states, y_off.
SSD_LEAVES = {
    "mamba2": [(1024, 256, 128, 256), (1024, 256, 256, 64), (1024, 128, 256, 64),
               (1024, 256, 128, 64)],
    "hymba": [(800, 256, 16, 256), (800, 256, 256, 64), (800, 16, 256, 64),
              (800, 256, 16, 64)],
}
# decode rows (G, M, K, N): granite-width and hymba-width leaves at 4 and 1
# rows, mamba2's decode-step state contraction (K = 1), an engine bucket
DECODE = [(1, 4, 2048, 8192), (1, 4, 1600, 5504), (1, 1, 1600, 32256), (128, 1, 128, 64),
          (128, 128, 1, 64), (1, 16, 2048, 2048)]
# the ragged kernel cases of chip_smoke.py (kernel_cases), as (G, X, Y, Z)
RAGGED = [(1, 37, 53, 45), (1, 3, 301, 45), (3, 19, 23, 21), (3, 2, 333, 45)]

SHAPES = ([("ssd", arch, s) for arch, leaves in SSD_LEAVES.items() for s in leaves]
          + [("decode", "", s) for s in DECODE] + [("ragged", "", s) for s in RAGGED])


def _xyz(kind, shape, l):
    if kind == "ragged":
        return shape
    G, M, K, N = shape
    return G, -(-M // l.m), -(-K // l.k), -(-N // l.n)


@pytest.mark.parametrize("kind,arch,shape", SHAPES,
                         ids=[f"{k}{'-' + a if a else ''}-{'x'.join(map(str, s))}"
                              for k, a, s in SHAPES])
def test_every_scheme_gets_a_plan_that_fits(kind, arch, shape):
    for l in talg.candidates(max_grid=5):
        G, X, Y, Z = _xyz(kind, shape, l)
        mn = l.m * l.n
        for shared_b in (False, True):
            p = tuning.plan_fused_f32(G, X, Y, Z, l.R, l.m, l.n, shared_b=shared_b)
            assert (p.bx, p.bz, p.tm) in tuning.F32_TILES, (l.name, p)
            assert p.pair == (p.tm == 8 and mn <= tuning.F32_ACC_REGS)
            assert p.bk == (8 if Y <= 8 else 32 if p.pair else 16)
            assert p.stages == tuning.F32_STAGES
            assert p.threads == tuning.fused_f32_threads(p.bx, p.bz, p.tm)
            assert p.smem_bytes == tuning.fused_f32_smem(p.bx, p.bz, p.tm, p.bk, mn, l.R)
            assert p.smem_bytes <= tuning.SMEM_BUDGET == 232_448
            regs = tuning.fused_f32_regs(p.tm, mn)
            assert regs <= tuning.REGS_PER_THREAD == 255
            assert regs * p.threads <= tuning.REGS_PER_SM
            assert p.acc_in_regs == (mn <= tuning.F32_ACC_REGS)
            assert p.units == l.R * -(-Y // p.bk)
            assert 1 <= p.splits <= p.split_max <= p.units
            assert p.splits == 1 or p.tiles < tuning.SMS
            assert G * p.splits <= 65_535
            found = []
            lint._check_f32(found, "t", "fused_gemm", p.as_dict(), G, X, Y, Z, l.R, mn,
                            tuning.SMEM_BUDGET, H100_SXM)
            assert not found, found


@pytest.mark.parametrize("arch", sorted(SSD_LEAVES))
def test_ssd_leaves_take_the_tiles_their_shapes_call_for(arch):
    """Under strassen (the forced scheme the SSD scan runs): a 32-wide tile
    where Z = 32 (but for hymba's 8-row states, which take the 8-row tile,
    64 wide: there is no 8 x 32 tile), 8-deep stages where K is 8."""
    l = talg.get("strassen")
    for G, M, K, N in SSD_LEAVES[arch]:
        X, Y, Z = M // 2, K // 2, N // 2
        p = tuning.plan_fused_f32(G, X, Y, Z, l.R, 2, 2)
        assert (p.bz == 32) == (Z == 32 and X > 8), (X, Y, Z, p)
        assert (p.bk == 8) == (Y <= 8)
        assert (p.bx == 8) == (X <= 8)
        assert p.acc_in_regs and p.splits == 1          # G x tiles fill the card
        assert X % p.bx == 0 or p.bx == 8


def test_decode_rows_take_the_short_tile_and_a_split():
    l = talg.get("strassen")
    p = tuning.plan_fused_f32(1, 2, 1024, 4096, l.R, 2, 2)
    assert (p.bx, p.tm) == (8, 2) and p.tiles == 64 and p.splits > 1
    assert p.blocks >= tuning.SMS
    assert tuning.plan_fused_f32(1, 256, 1024, 4096, l.R, 2, 2).splits == 1


def _kernel_walk(at, bt, w, p):
    """The reduction as the kernel runs it, in float32: each split walks its
    range of the flattened (rank, K-stage) steps, sums each step's product
    into H, folds H into the m*n accumulators at a rank's end (or its range's
    end) in ascending rank through the CSR table, and the splits' partials
    are summed in ascending split order."""
    G, R, X, Y = at.shape
    Z = bt.shape[-1]
    mn = w.shape[1] * w.shape[2]
    tab = coeff_table(w, torch.device("cpu")).numpy()
    row_ptr, nnz = tab[:R + 1], tab[R]
    part, coeff = tab[R + 1:R + 1 + nnz], tab[R + 1 + nnz:]
    kcs = -(-Y // p.bk)
    total = None
    for b, e in tuning.split_ranges(p.units, p.splits):
        acc = torch.zeros(G, mn, X, Z)
        h = torch.zeros(G, X, Z)
        for u in range(b, e):
            r, kc = divmod(u, kcs)
            ys = slice(kc * p.bk, min(Y, kc * p.bk + p.bk))
            h += at[:, r, :, ys] @ bt[:, r, ys, :]
            if kc == kcs - 1 or u == e - 1:
                for t in range(row_ptr[r], row_ptr[r + 1]):
                    acc[:, part[t]] += float(coeff[t]) * h
                h = torch.zeros(G, X, Z)
        total = acc if total is None else total + acc
    return total.reshape(G, *w.shape[1:], X, Z)


@pytest.mark.parametrize("G,X,Y,Z", [(2, 37, 53, 45), (1, 3, 301, 45), (3, 2, 333, 45),
                                     (2, 64, 8, 32), (1, 9, 40, 70)])
@pytest.mark.parametrize("name", ["strassen", "laderman", "s444"])
def test_planned_walk_gives_the_plain_result(name, G, X, Y, Z):
    """The steps, splits and Combine H order the plan gives reproduce the
    plain version (``ref.fused_gemm_combine_h_ref``) within the f32 bound."""
    l = talg.get(name)
    rng = np.random.default_rng(7)
    at = torch.tensor(rng.standard_normal((G, l.R, X, Y)), dtype=torch.float32)
    bt = torch.tensor(rng.standard_normal((G, l.R, Y, Z)), dtype=torch.float32)
    p = tuning.plan_fused_f32(G, X, Y, Z, l.R, l.m, l.n)
    want = ref.fused_gemm_combine_h_ref(at, bt, l.W)
    torch.testing.assert_close(_kernel_walk(at, bt, l.W, p), want, **FUSED_F32)
    if X <= 3:
        assert p.splits > 1                  # the walk above crossed split boundaries
