"""The port's Decision Module, planner entry points and offline Combine B
against the reference, on the CPU.

Both packages price with a profile built from the same field dict, so the
comparison is of the pricing code, not of profiles: the port's own data-sheet
``h100_sxm`` numbers, and a compute-rich profile under which LCMAs win.
Decisions must pick the same scheme with the same predicted times.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decision as jdec, falcon_gemm as jfg, hardware as jhw
from repro_torch.core import decision as tdec, falcon_gemm as tfg, hardware as thw
from repro_torch.core.hardware import H100_SXM

COMPUTE_RICH = dict(name="parity_compute_rich", flops_mul=2e12, flops_add=5e13,
                    beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
                    mxu_align=8, dtype_flops={"float32": 1e12},
                    lcma_gemm_efficiency=0.9)


def _profiles(fields: dict):
    return (jhw.register_profile(jhw.HardwareProfile(**fields)),
            thw.register_profile(thw.HardwareProfile(**fields)))


PROFILES = {"h100": dict(H100_SXM.to_dict(), name="parity_h100"),
            "compute_rich": COMPUTE_RICH}
SHAPES = [(1, 2048, 2048), (4, 2048, 512), (64, 256, 512), (256, 2048, 8192),
          (1000, 999, 1001), (4096, 8192, 2048), (4096, 2048, 49408)]


def _same(dj, dt):
    assert (dj.algo.name if dj.algo else None) == (dt.algo.name if dt.algo else None)
    assert (dj.M, dj.N, dj.K, dj.dtype) == (dt.M, dt.N, dt.K, dt.dtype)
    assert dt.gemm_seconds == pytest.approx(dj.gemm_seconds, rel=1e-12)
    if dj.lcma_seconds is None:
        assert dt.lcma_seconds is None
    else:
        assert dt.lcma_seconds == pytest.approx(dj.lcma_seconds, rel=1e-12)
    assert len(dt.estimates) == len(dj.estimates)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precombined_b", [False, True])
def test_decide_matches_reference(profile, dtype, precombined_b):
    hj, ht = _profiles(PROFILES[profile])
    picked = set()
    for M, K, N in SHAPES:
        dj = jdec.decide(M, N, K, hj, dtype, precombined_b=precombined_b,
                         min_speedup=1.02)
        dt = tdec.decide(M, N, K, ht, dtype, precombined_b=precombined_b,
                         min_speedup=1.02)
        _same(dj, dt)
        picked.add(dt.algo.name if dt.algo else "gemm")
    if profile == "compute_rich":
        assert picked - {"gemm"}, "the grid should exercise LCMA picks"


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("shared_b", [False, True])
def test_decide_batched_matches_reference(profile, shared_b):
    hj, ht = _profiles(PROFILES[profile])
    for B, M, K, N in [(1, 256, 2048, 2048), (8, 64, 64, 80), (128, 64, 64, 64),
                       (16, 512, 1024, 1024), (3, 13, 23, 17)]:
        for dtype in ("float32", "bfloat16"):
            dj = jdec.decide_batched(B, M, N, K, hj, dtype, shared_b=shared_b)
            dt = tdec.decide_batched(B, M, N, K, ht, dtype, shared_b=shared_b)
            _same(dj, dt)
            assert (dj.B, dj.shared_b) == (dt.B, dt.shared_b)


@pytest.mark.parametrize("mode", ["auto", "gemm", "strassen", "laderman"])
def test_plan_entry_points_match_reference(mode):
    hj, ht = _profiles(COMPUTE_RICH)
    jc = jfg.FalconConfig(hardware=hj.name, mode=mode)
    tc = tfg.FalconConfig(hardware=ht.name, mode=mode)
    for M, K, N in SHAPES:
        for pre in (False, True):
            _same(jfg.plan(M, K, N, jc, "bfloat16", precombined_b=pre),
                  tfg.plan(M, K, N, tc, "bfloat16", precombined_b=pre))
        _same(jfg.plan_batched(4, M, K, N, jc, "float32", shared_b=True),
              tfg.plan_batched(4, M, K, N, tc, "float32", shared_b=True))
    restricted = dict(candidates=("strassen",))
    _same(jfg.plan(4096, 2048, 2048, dataclasses.replace(jc, **restricted), "bfloat16",
                   precombined_b=True),
          tfg.plan(4096, 2048, 2048, dataclasses.replace(tc, **restricted), "bfloat16",
                   precombined_b=True))


def test_h100_profile_is_the_default_and_declines_serving_shapes():
    """The port prices on h100_sxm by default; on its data-sheet numbers the
    Eq. 8 guard declines granite's projections at batch-4 serving shapes."""
    cfg = tfg.FalconConfig()
    assert cfg.hardware == "h100_sxm" and cfg.backend == "cuda"
    assert cfg.profile.vmem_bytes == 232_448
    assert cfg.profile.flops_for("bfloat16") == 989e12
    for M in (4, 256):
        for K, N in [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]:
            assert not tfg.plan(M, K, N, cfg, "bfloat16").use_lcma
            assert tdec.eq8_is_memory_bound(M, N, K, H100_SXM, "bfloat16")


def test_dtype_bytes_fallback():
    assert tdec._dtype_bytes("float8_e4m3fn") == 1
    assert tdec._dtype_bytes("int32") == 4
    with pytest.raises(ValueError):
        tdec._dtype_bytes("not_a_dtype")


@pytest.mark.parametrize("name", ["strassen", "strassen-winograd", "laderman", "s223",
                                  "s555"])
def test_precombine_weights_matches_reference(name, rng):
    from repro.core import algorithms as jalg
    from repro_torch.core import algorithms as talg
    jl, tl = jalg.get(name), talg.get(name)
    w = rng.standard_normal((37, 29)).astype(np.float32)
    want = np.asarray(jfg.precombine_weights(jnp.asarray(w), jl))
    got = tfg.precombine_weights(torch.tensor(w), tl)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    stacked = tfg.precombine_weights(torch.tensor(np.stack([w, 2 * w])), tl)
    np.testing.assert_allclose(stacked[1].numpy(), 2 * want, atol=2e-6, rtol=1e-6)
