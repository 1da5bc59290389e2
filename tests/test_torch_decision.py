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


# ---------------------------------------------------------------------------
# The int8 tier
# ---------------------------------------------------------------------------

QUANT_PROFILES = {"h100": PROFILES["h100"],
                  "cpu": dict(thw.CPU_HOST.to_dict(), name="parity_cpu")}
# granite's projections at decode (M = 4) and prefill (M = 256), and a
# ragged shape whose combined K takes a short scale block
QUANT_SHAPES = [(M, K, N) for M in (4, 256)
                for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                             (2048, 49408))] + [(1000, 999, 1001), (64, 256, 512)]


def _same_quant(dj, dt):
    _same(dj, dt)
    assert dj.precision == dt.precision and dj.quantized == dt.quantized
    assert [e.precision for e in dt.estimates] == [e.precision for e in dj.estimates]


@pytest.mark.parametrize("profile", sorted(QUANT_PROFILES))
@pytest.mark.parametrize("precombined_b", [False, True])
def test_decide_quant_matches_reference(profile, precombined_b):
    hj, ht = _profiles(QUANT_PROFILES[profile])
    tiers = set()
    for M, K, N in QUANT_SHAPES:
        for budget in (None, 0.05):
            kw = dict(precombined_b=precombined_b, min_speedup=1.02,
                      accuracy_budget=budget, quantize=True)
            dj = jdec.decide(M, N, K, hj, "bfloat16", **kw)
            dt = tdec.decide(M, N, K, ht, "bfloat16", **kw)
            _same_quant(dj, dt)
            tiers.add(dt.precision if dt.use_lcma else "gemm")
    if profile == "h100" and precombined_b:
        assert "int8" in tiers


@pytest.mark.parametrize("profile", sorted(QUANT_PROFILES))
@pytest.mark.parametrize("shared_b", [False, True])
def test_decide_batched_quant_matches_reference(profile, shared_b):
    hj, ht = _profiles(QUANT_PROFILES[profile])
    for B, M, K, N in [(1, 256, 2048, 8192), (2, 4, 2048, 2048), (128, 64, 64, 80),
                       (16, 512, 1024, 1024), (3, 13, 23, 17)]:
        for pre in (False, True):
            kw = dict(precombined_b=pre, shared_b=shared_b, quantize=True)
            dj = jdec.decide_batched(B, M, N, K, hj, "bfloat16", **kw)
            dt = tdec.decide_batched(B, M, N, K, ht, "bfloat16", **kw)
            _same_quant(dj, dt)
            assert (dj.B, dj.shared_b) == (dt.B, dt.shared_b)


def test_quant_tier_on_h100_picks_int8_strassen_for_granite():
    """Auto mode with the int8 tier on the data-sheet profile: at the prefill
    hint (M = 256) only mlp_gate/mlp_up (2048 -> 8192) take int8 strassen
    against a precombined weight; at decode (M = 4) every projection does.
    Without ``quantize`` none does (the Eq. 8 guard declines them)."""
    cfg = tfg.FalconConfig(quantize=True, min_speedup=1.02)
    proj = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    for M, picked in ((256, {(2048, 8192)}), (4, set(proj))):
        for K, N in proj:
            d = tfg.plan(M, K, N, cfg, "bfloat16", precombined_b=True)
            assert d.quantized == ((K, N) in picked), (M, K, N)
            if d.quantized:
                assert d.algo.name == "strassen" and d.speedup > 1.02
            fp = tfg.plan(M, K, N, dataclasses.replace(cfg, quantize=False), "bfloat16",
                          precombined_b=True)
            assert not fp.use_lcma


def test_plan_key_gains_quant_token_only_when_quantizing():
    from repro_torch.core import plan_cache
    hw = thw.get_profile("h100_sxm")
    plain = plan_cache.plan_key(4, 2048, 2048, hw, "bfloat16", precombined_b=True)
    quant = plan_cache.plan_key(4, 2048, 2048, hw, "bfloat16", precombined_b=True,
                                quantize=True)
    assert "quant=" not in plain
    assert quant == plain + "|quant=1"
    grouped = plan_cache.plan_key(4, 2048, 2048, hw, "bfloat16", batch=2, quantize=True)
    assert grouped.endswith("|quant=1") and grouped != quant


def test_plan_cache_round_trip_keeps_precision(tmp_path):
    """A cached int8 decision comes back int8, from memory and from disk; an
    fp plan of the same shape has its own key."""
    from repro_torch.core import plan_cache
    path = str(tmp_path / "plans.json")
    cache = plan_cache.configure(path)
    try:
        cfg = tfg.FalconConfig(quantize=True, min_speedup=1.02)
        d = tfg.plan(4, 2048, 8192, cfg, "bfloat16", precombined_b=True)
        g = tfg.plan_batched(2, 4, 2048, 2048, cfg, "bfloat16", precombined_b=True,
                             shared_b=True)
        assert d.quantized and g.quantized
        assert tfg.plan(4, 2048, 8192, cfg, "bfloat16", precombined_b=True) is d
        assert cache.stats.hits == 1
        fp = tfg.plan(4, 2048, 8192, dataclasses.replace(cfg, quantize=False), "bfloat16",
                      precombined_b=True)
        assert not fp.use_lcma and len(cache) == 3
        cache.save()
    finally:
        plan_cache.reset()
    fresh = plan_cache.PlanCache(path)
    assert len(fresh) == 3
    got = {k: fresh.lookup(k) for k in fresh.keys()}
    for key, dd in got.items():
        assert dd.precision == ("int8" if "quant=1" in key else "fp")
    assert sum(dd.quantized for dd in got.values()) == 2
    assert sum(isinstance(dd, tdec.GroupedDecision) for dd in got.values()) == 1
