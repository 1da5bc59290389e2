"""The port's shard-aware Decision Module against the reference's, and the
collective probe.

* ``decide_sharded`` and ``plan_sharded`` (auto, gemm, forced strassen)
  equal the reference's bit for bit, over shapes x {h100_sxm, cpu_host,
  each with ``collective_bw`` set and unset} x {bf16, f32} x D in {2, 4, 8},
  with and without the int8 tier; so do the pure pricing helpers
  (``collective_bytes``, ``collective_cost``, ``gemm_time_sharded``,
  ``estimate_sharded``) and the FSDP layouts.
* The collective term flips the layout: at 8192^3 on h100_sxm's NVLink
  rate a sharded layout wins, over a 1 GB/s link the replicated one.
* ``plan(mesh=...)`` promotes to the sharded tier; the ``ly=`` key part
  round-trips a ``ShardedDecision`` through a saved plan cache.
* The profiles carry ``link_bw`` and ``collective_bw`` through their dict
  and JSON forms; ``coll_bw()`` is the measured rate where there is one.
* ``measure_collective_bw`` is None on a world of one and a rate above 0
  on 2 gloo ranks (spawned CPU processes); ``autotune(collectives=True)``
  records it there.
"""
import dataclasses

import pytest

import _torch_mesh_ranks as ranks
from repro.core import algorithms as jalg, decision as jdec, falcon_gemm as jfg
from repro.core import hardware as jhw, plan_cache as jcache
from repro_torch.core import algorithms as talg, decision as tdec, falcon_gemm as tfg
from repro_torch.core import hardware as thw, plan_cache as tcache
from repro_torch.core.autotune import measure_collective_bw
from repro_torch.parallel import mesh as PM

SHAPES = [(8192, 8192, 8192), (256, 2048, 8192), (4, 2048, 49408), (2048, 8192, 2048),
          (512, 1000, 3000)]
DEVICES = (2, 4, 8)
PROFILES = ["h100_sxm", "h100_sxm+cb", "cpu_host", "cpu_host+cb"]


def _profiles(name: str):
    """(port profile, reference profile) with the same numbers; ``+cb``: a
    measured collective rate of 37 GB/s."""
    base, _, cb = name.partition("+")
    t = thw.get_profile(base)
    if cb:
        t = dataclasses.replace(t, name=f"{base}_cb", collective_bw=37e9)
    return t, jhw.HardwareProfile.from_dict(t.to_dict())


def _same(t, j):
    """Two decisions equal field for field (the scheme by name)."""
    assert type(t).__name__ == type(j).__name__
    assert (t.algo and t.algo.name) == (j.algo and j.algo.name)
    for f in ("M", "N", "K", "dtype", "gemm_seconds", "lcma_seconds", "precision"):
        assert getattr(t, f) == getattr(j, f), f
    if isinstance(j, jdec.ShardedDecision):
        for f in ("layout", "n_devices", "collective_seconds", "local_shape_mnk"):
            assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("profile", PROFILES)
def test_decide_sharded_matches_reference(profile, dtype):
    thw_, jhw_ = _profiles(profile)
    for (M, K, N) in SHAPES:
        for D in DEVICES:
            for quantize in (False, True):
                for layouts in ((tdec.default_layouts(), jdec.default_layouts()),
                                (tdec.fsdp_layouts(), jdec.fsdp_layouts())):
                    t = tdec.decide_sharded(M, N, K, thw_, dtype, n_devices=D,
                                            layouts=layouts[0], quantize=quantize)
                    j = jdec.decide_sharded(M, N, K, jhw_, dtype, n_devices=D,
                                            layouts=layouts[1], quantize=quantize)
                    _same(t, j)
                    assert t.communication_avoiding == j.communication_avoiding
                    assert t.collective_fraction == j.collective_fraction


@pytest.mark.parametrize("profile", PROFILES)
def test_sharded_pricing_helpers_match_reference(profile):
    thw_, jhw_ = _profiles(profile)
    assert thw_.coll_bw() == jhw_.coll_bw()
    l_t, l_j = talg.get("strassen"), jalg.get("strassen")
    for (M, K, N) in SHAPES:
        for D in DEVICES:
            for lt, lj in zip(tdec.default_layouts() + tdec.fsdp_layouts(),
                              jdec.default_layouts() + jdec.fsdp_layouts()):
                assert lt == tdec.layout_by_name(lj.name) and lt.shard == lj.shard
                assert tdec.local_shape(lt, M, N, K, D) == jdec.local_shape(lj, M, N, K, D)
                assert tdec.collective_bytes(lt, M, N, K, D) == \
                    jdec.collective_bytes(lj, M, N, K, D)
                assert dataclasses.astuple(tdec.collective_cost(lt, M, N, K, D, thw_)) == \
                    dataclasses.astuple(jdec.collective_cost(lj, M, N, K, D, jhw_))
                assert tdec.gemm_time_sharded(M, N, K, thw_, lt, D) == \
                    jdec.gemm_time_sharded(M, N, K, jhw_, lj, D)
                te = tdec.estimate_sharded(l_t, M, N, K, thw_, layout=lt, n_devices=D)
                je = jdec.estimate_sharded(l_j, M, N, K, jhw_, layout=lj, n_devices=D)
                assert (te.time, te.layout, te.n_devices) == (je.time, je.layout, je.n_devices)
    with pytest.raises(KeyError):
        tdec.layout_by_name("diagonal")


@pytest.fixture()
def both_profiles():
    """Every test profile registered in both packages (plan() resolves
    names); the registries are restored after."""
    saved = dict(thw._PROFILES), dict(jhw._PROFILES)
    for name in PROFILES:
        t, j = _profiles(name)
        thw.register_profile(t)
        jhw.register_profile(j)
    yield
    for reg, old in zip((thw._PROFILES, jhw._PROFILES), saved):
        reg.clear()
        reg.update(old)
    jcache.configure()
    tcache.configure()


@pytest.mark.parametrize("mode", ["auto", "gemm", "strassen"])
@pytest.mark.parametrize("profile", PROFILES)
def test_plan_sharded_matches_reference(both_profiles, profile, mode):
    hw = {"h100_sxm+cb": "h100_sxm_cb", "cpu_host+cb": "cpu_host_cb"}.get(profile, profile)
    tcfg = tfg.FalconConfig(hardware=hw, mode=mode)
    jcfg = jfg.FalconConfig(hardware=hw, mode=mode, backend="jnp")
    jcache.configure()
    tcache.configure()
    for dtype in ("bfloat16", "float32"):
        for (M, K, N) in SHAPES:
            for D in DEVICES:
                t = tfg.plan_sharded(M, K, N, tcfg, dtype, n_devices=D,
                                     layouts=tdec.default_layouts())
                j = jfg.plan_sharded(M, K, N, jcfg, dtype, n_devices=D,
                                     layouts=jdec.default_layouts())
                _same(t, j)
                # a cache hit gives the same decision back
                _same(tfg.plan_sharded(M, K, N, tcfg, dtype, n_devices=D,
                                       layouts=tdec.default_layouts()), j)


def test_plan_with_a_mesh_promotes_to_the_sharded_tier(both_profiles):
    from jax.sharding import AbstractMesh
    tcfg = tfg.FalconConfig(hardware="h100_sxm")
    jcfg = jfg.FalconConfig(hardware="h100_sxm", backend="jnp")
    for d, m in ((1, 2), (2, 4), (1, 8)):
        t = tfg.plan(4096, 4096, 4096, tcfg, mesh={"data": d, "model": m})
        j = jfg.plan(4096, 4096, 4096, jcfg, mesh=AbstractMesh((d, m), ("data", "model")))
        assert isinstance(t, tdec.ShardedDecision) and t.n_devices == m
        _same(t, j)
    local = tfg.plan(4096, 4096, 4096, tcfg)
    assert not isinstance(local, tdec.ShardedDecision)
    # under the ambient mesh (none here): the local model, one replicated layout
    t = tfg.plan_sharded(4096, 4096, 4096, tcfg)
    assert (t.layout, t.n_devices) == ("replicated", 1)


def test_collective_term_flips_the_layout():
    """8192^3 bf16 over 8 devices: over h100_sxm's NVLink rate (450 GB/s,
    data sheet) a sharded layout beats the full contraction everywhere;
    over a 1 GB/s link the replicated one wins. Both packages agree."""
    fast_t, fast_j = _profiles("h100_sxm")
    slow_t = dataclasses.replace(fast_t, collective_bw=1e9)
    slow_j = jhw.HardwareProfile.from_dict(slow_t.to_dict())
    fast = tdec.decide_sharded(8192, 8192, 8192, fast_t, "bfloat16", n_devices=8)
    slow = tdec.decide_sharded(8192, 8192, 8192, slow_t, "bfloat16", n_devices=8)
    assert fast.communication_avoiding and not slow.communication_avoiding
    assert fast.layout != slow.layout == "replicated"
    assert fast.collective_seconds > 0.0 and slow.collective_seconds == 0.0
    assert fast.seconds < slow.seconds
    _same(fast, jdec.decide_sharded(8192, 8192, 8192, fast_j, "bfloat16", n_devices=8))
    _same(slow, jdec.decide_sharded(8192, 8192, 8192, slow_j, "bfloat16", n_devices=8))


def test_sharded_key_round_trips_through_a_saved_cache(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = tcache.configure(path=path, autoload=False)
    try:
        cfg = tfg.FalconConfig(mode="auto")
        d1 = tfg.plan_sharded(4096, 4096, 4096, cfg, "bfloat16", n_devices=8,
                              layouts=tdec.default_layouts())
        misses = cache.stats.misses
        d2 = tfg.plan_sharded(4096, 4096, 4096, cfg, "bfloat16", n_devices=8,
                              layouts=tdec.default_layouts())
        assert isinstance(d1, tdec.ShardedDecision)
        assert cache.stats.hits >= 1 and cache.stats.misses == misses
        assert (d2.layout, d2.n_devices) == (d1.layout, d1.n_devices)
        key = next(k for k in cache.keys() if "ly=" in k)
        assert key.endswith(f"|ly=replicated,col,rowxD8@cb={thw.get_profile('h100_sxm').coll_bw():g}")
        cache.save()
        fresh = tcache.PlanCache(path=path)
        hit = fresh.lookup(key)
        assert isinstance(hit, tdec.ShardedDecision)
        assert (hit.layout, hit.local_shape_mnk, hit.collective_seconds) == \
            (d1.layout, d1.local_shape_mnk, d1.collective_seconds)
        # the key embeds the collective rate: a measured one keys apart
        measured = dataclasses.replace(thw.get_profile("h100_sxm"), collective_bw=5e9)
        assert tcache.plan_key(4096, 4096, 4096, measured, "bfloat16", layout="col",
                               n_devices=8) != \
            tcache.plan_key(4096, 4096, 4096, thw.get_profile("h100_sxm"), "bfloat16",
                            layout="col", n_devices=8)
    finally:
        tcache.configure()


def test_profiles_carry_link_and_collective_rates(tmp_path):
    h100, cpu = thw.get_profile("h100_sxm"), thw.get_profile("cpu_host")
    assert (h100.link_bw, h100.collective_bw, h100.coll_bw()) == (450e9, 0.0, 450e9)
    assert (cpu.link_bw, cpu.coll_bw()) == (1e9, jhw.CPU_HOST.coll_bw())
    measured = dataclasses.replace(h100, name="h100_measured", collective_bw=12e9)
    assert measured.coll_bw() == 12e9
    assert thw.HardwareProfile.from_dict(measured.to_dict()) == measured
    path = thw.save_profile(measured, str(tmp_path / "p.json"))
    loaded = thw.load_profile(path, register=False)
    assert (loaded.link_bw, loaded.collective_bw) == (450e9, 12e9)
    # the reference's dict form takes the port's, field for field
    assert set(thw.HardwareProfile.__dataclass_fields__) == \
        set(jhw.HardwareProfile.__dataclass_fields__)


def test_collective_probe_on_a_world_of_one_is_none():
    assert PM.world_mesh() is None
    assert measure_collective_bw(size_bytes=1 << 12, reps=1, warmup=0) is None


def test_collective_probe_on_two_gloo_ranks(tmp_path):
    bws = PM.run_ranks(ranks.collective_probe, {"model": 2}, device="cpu",
                       workdir=str(tmp_path), timeout=120)
    assert all(bw is not None and bw > 0 for bw in bws)


def test_autotune_records_the_collective_rate(tmp_path):
    out = PM.run_ranks(ranks.autotune_collectives, {"model": 2}, "probe_mesh", device="cpu",
                       workdir=str(tmp_path), timeout=120)
    for measured, recorded_bw, recorded in out:
        assert measured > 0 and recorded and recorded_bw == measured
