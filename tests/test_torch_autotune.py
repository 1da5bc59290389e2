"""The port's calibration path against the reference, on the CPU.

The tiled GEMM's plain version against the reference's Pallas
``tiled_matmul`` in interpret mode (the reference kernel tests' tolerances:
f32 1e-5, bf16 atol 6e-2 / rtol 2e-2); the autotuner under the reference's
deterministic clock (seconds as a function of operand sizes only), so both
packages fit the same numbers from the same probes; the warm grid; the
decisions under the calibrated profiles; profile persistence; and the tune
CLI feeding the launcher's ``--plan-cache``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat, falcon_gemm as jfg, hardware as jhw
from repro.core import plan_cache as jpc, workloads as jwl
from repro.kernels import ops as jops
from repro.kernels.fused_gemm import tiled_matmul as j_tiled
from repro_torch import kernels as K
from repro_torch.core import autotune as tat, decision as tdec, falcon_gemm as tfg
from repro_torch.core import hardware as thw, plan_cache as tpc, workloads as twl

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=6e-2, rtol=2e-2)}
PROBES = [(16, 16, 16), (32, 16, 32)]
WORKLOADS = ["deepseek_r1", "qwen3_5", "hunyuan_video", "granite_3_2b"]


@pytest.fixture(autouse=True)
def isolated_profiles(tmp_path, monkeypatch):
    """Point both packages' profile dirs at a tmpdir and undo their
    registry and plan-cache side effects."""
    monkeypatch.setenv(thw.ENV_PROFILE_DIR, str(tmp_path))
    before = dict(jhw._PROFILES), dict(thw._PROFILES)
    jpc.reset()
    tpc.reset()
    yield tmp_path
    for reg, saved in zip((jhw._PROFILES, thw._PROFILES), before):
        reg.clear()
        reg.update(saved)
    jpc.reset()
    tpc.reset()


def model_timer(fn, *args):
    """Deterministic 'clock': seconds as a pure function of operand sizes
    (the reference's tests/test_autotune.py timer)."""
    elems = sum(int(np.prod(a.shape)) for a in args)
    return 1e-9 * elems + 1e-6


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matmul_matches_pallas(dtype, rng):
    (aj, at), (bj, bt) = (_pair(rng.standard_normal((48, 64)), dtype),
                          _pair(rng.standard_normal((64, 32)), dtype))
    want = j_tiled(aj, bj, block=(16, 16, 16), interpret=True)
    got = K.tiled_matmul(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matmul_matches_matmul_pallas_ragged(dtype, rng):
    (aj, at), (bj, bt) = (_pair(rng.standard_normal((13, 23)), dtype),
                          _pair(rng.standard_normal((23, 17)), dtype))
    want = jops.matmul_pallas(aj, bj, interpret=True)
    got = K.matmul(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == want.shape == (13, 17)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_tiled_matmul_rounds_once_to_out_dtype(rng):
    a = torch.tensor(rng.standard_normal((24, 40))).bfloat16()
    b = torch.tensor(rng.standard_normal((40, 8))).bfloat16()
    got = K.tiled_matmul(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), atol=1e-5, rtol=1e-6)


def test_tiled_matmul_refuses_bad_operands():
    before = K.launch_counts()
    with pytest.raises(TypeError):
        K.tiled_matmul(torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, 4))
    with pytest.raises(TypeError):
        K.tiled_matmul(torch.zeros(4, 4), torch.zeros(4, 4), out_dtype=torch.float16)
    with pytest.raises(ValueError):
        K.tiled_matmul(torch.zeros(4, 5), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        K.matmul(torch.zeros(4, 5), torch.zeros(6, 4))
    K.matmul(torch.ones(3, 5), torch.ones(5, 2))
    assert K.launch_counts() == before      # the CPU path launches nothing


def _common(a: dict, b: dict) -> tuple[dict, dict]:
    keys = sorted(set(a) & set(b))
    return {k: a[k] for k in keys}, {k: b[k] for k in keys}


def _calibrate_both(quant: bool, **kw):
    kw = dict(base="cpu_host", shapes=PROBES, timer=model_timer, validate=True,
              quant=quant, **kw)
    return (jat.autotune(backend="pallas_interpret", **kw),
            tat.autotune(backend="cuda", device="cpu", **kw))


@pytest.mark.parametrize("quant", [False, True])
def test_autotune_matches_reference(quant):
    rj, rt = _calibrate_both(quant)
    pj, pt = rj.profile, rt.profile
    assert pt.name == pj.name == "cpu_host_autotuned"
    assert thw.get_profile(pt.name) is pt                 # registered by name
    for f in ("flops_mul", "flops_add", "beta", "lcma_gemm_efficiency"):
        assert getattr(pt, f) == pytest.approx(getattr(pj, f), rel=1e-12), f
    assert pt.dtype_flops == pj.dtype_flops
    for f in ("flops_int8", "beta_quant"):
        want = getattr(rj, f)
        assert (getattr(rt, f) is None) if want is None else \
            getattr(rt, f) == pytest.approx(want, rel=1e-12), f
    assert (rt.flops_int8 is not None) == quant
    assert rt.model_rel_err == pytest.approx(rj.model_rel_err, rel=1e-12)
    assert len(rt.model_rel_err) == len(PROBES)
    assert len(rt.probes) == len(rj.probes) == len(PROBES)
    for p_t, p_j in zip(rt.probes, rj.probes):
        got, want = _common(p_t.as_dict(), p_j.as_dict())
        assert set(got) >= {"t_gemm", "t_combine_a", "t_batched", "t_pipeline",
                            "flops_mul_est", "beta_est", "eff_est", "flops_int8_est"}
        assert got == pytest.approx(want, rel=1e-12)


def test_autotune_checks_backend_device_and_int8_shapes():
    with pytest.raises(ValueError, match="backend"):
        tat.autotune(base="cpu_host", backend="pallas", device="cpu", timer=model_timer)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tat.autotune(base="cpu_host", timer=model_timer)
    with pytest.raises(ValueError, match="M > 16"):
        tat._int8_operands(16, 64, 64, torch.device("cuda"))
    with pytest.raises(ValueError, match="multiples of 8"):
        tat._int8_operands(32, 60, 64, torch.device("cuda"))
    assert tat.default_probe_shapes() == [(256, 2048, 8192), (256, 8192, 2048),
                                          (4096, 4096, 4096)]


def test_report_names_the_clock_that_fitted_it(isolated_profiles):
    """The report records its timer's clock: ``best_of_timer`` reads the
    host's, an injected stub its own name; the default on the CPU is the
    host clock. ``calibrate(host_clock=True)`` writes the profile of the
    first fit and records a host-clock fit beside it. The device timer
    itself (CUDA events) runs only on a card (``chip_smoke.py``'s ``tune``)."""
    kw = dict(base="cpu_host", shapes=PROBES[:1], validate=True, device="cpu", reps=1, warmup=0)
    host = tat.autotune(timer=tat.best_of_timer(reps=1, warmup=0, device="cpu"), **kw)
    stub = tat.autotune(timer=model_timer, name="stub_fit", **kw)
    default = tat.autotune(name="default_fit", **kw)
    assert (host.clock, stub.clock, default.clock) == ("host", "model_timer", "host")
    assert host.metadata()["clock"] == "host"
    assert tat.timer_clock(tat.device_timer()) == "device"
    report, path = tat.calibrate(path=str(isolated_profiles / "fit.json"), timer=model_timer,
                                 host_clock=True, block_plan_shapes=False, name="fit", **kw)
    meta = json.load(open(path))["_metadata"]
    assert meta["clock"] == "model_timer" and meta["host_clock"]["clock"] == "host"
    assert meta["host_clock"]["flops_mul"] > 0 and len(meta["host_clock"]["model_rel_err"]) == 1
    assert thw.get_profile("fit") is report.profile                    # the first fit's
    assert thw.get_profile("fit_hostclock").flops_mul == meta["host_clock"]["flops_mul"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_warm_grid_matches_reference(workload):
    assert twl.warm_shapes(workload) == jwl.warm_shapes(workload)
    assert twl.dense_projection_shapes(workload) == jwl.dense_projection_shapes(workload)
    for quantize in (False, True):
        fields = ("kind", "role", "m", "k", "n", "group", "shared_b", "weight_static")
        got = [tuple(getattr(s, f) for f in fields)
               for s in twl.contraction_set(workload, quantize=quantize)]
        want = [tuple(getattr(s, f) for f in fields)
                for s in jwl.contraction_set(workload, quantize=quantize)]
        assert got == want


def test_paper_workloads_and_shape_token():
    assert twl.paper_workloads() == jwl.paper_workloads()
    for w in twl.paper_workloads():
        assert twl.paper_projection_shapes(w) == jwl.paper_projection_shapes(w)
    c = twl.Contraction("attention", "attn.qk", 64, 64, 80, group=128)
    key = tpc.plan_key(c.m, c.k, c.n, thw.CPU_HOST, "bfloat16", batch=c.group)
    assert twl.shape_token(key) == jwl.shape_token(key) == c.key_shape()


@pytest.mark.parametrize("quant", [False, True])
def test_calibrated_decisions_match_reference(quant):
    """Under each calibrated profile, plan() takes the same decision in both
    packages for every granite warm shape, fp and int8 tiers, and prices
    every candidate alike (under these clock-model profiles the GEMM wins
    each shape, so the candidates' prices are what the test compares)."""
    rj, rt = _calibrate_both(quant, name=f"parity_cal_q{int(quant)}")
    name = rt.profile.name
    for M, K_, N in twl.warm_shapes("granite_3_2b"):
        for pre in (False, True):
            dj = jfg.plan(M, K_, N, jfg.FalconConfig(hardware=name, quantize=quant),
                          "bfloat16", precombined_b=pre)
            dt = tfg.plan(M, K_, N, tfg.FalconConfig(hardware=name, quantize=quant),
                          "bfloat16", precombined_b=pre)
            assert (dt.use_lcma, dt.precision) == (dj.use_lcma, dj.precision)
            assert (dt.algo and dt.algo.name) == (dj.algo and dj.algo.name)
            assert dt.gemm_seconds == pytest.approx(dj.gemm_seconds, rel=1e-12)
            assert [(e.lcma.name, e.precision) for e in dt.estimates] == \
                [(e.lcma.name, e.precision) for e in dj.estimates]
            assert [e.time for e in dt.estimates] == \
                pytest.approx([e.time for e in dj.estimates], rel=1e-12)


def test_calibrate_persists_profile_and_block_plans(isolated_profiles):
    rep, path = tat.calibrate(base="cpu_host", backend="cuda", device="cpu",
                              shapes=PROBES, timer=model_timer, quant=True,
                              name="testhost_autotuned")
    assert path == thw.profile_path("testhost_autotuned")
    doc = json.load(open(path))
    assert doc["name"] == rep.profile.name and doc["dtype_flops"]["int8"] > 0
    meta = doc["_metadata"]
    assert meta["backend"] == "cuda" and meta["scheme"] == "strassen"
    assert len(meta["probes"]) == len(PROBES) and meta["flops_int8"] == rep.flops_int8
    for name in ("strassen", "laderman"):
        bp = meta["block_plans"][name]
        budget = bp["smem_budget_bytes"]
        assert budget == min(thw.CPU_HOST.vmem_bytes, 232_448)
        for k, v in bp.items():
            if k.endswith("_smem_bytes"):
                assert 0 < v <= budget, (name, k)
        Mp, Kp, Np = bp["padded_shape"]
        assert (Mp % bp["grid"][0], Kp % bp["grid"][1], Np % bp["grid"][2]) == (0, 0, 0)
    assert thw.load_profile(path, register=False).to_dict() == rep.profile.to_dict()
    # drop the in-memory registration: decide() must load the JSON
    thw._PROFILES.pop("testhost_autotuned")
    d = tdec.decide(8192, 8192, 8192, "testhost_autotuned", "float32")
    assert d.gemm_seconds == pytest.approx(
        tdec.gemm_time(8192, 8192, 8192, rep.profile, "float32"))
    assert tfg.FalconConfig(hardware="testhost_autotuned").profile.beta == \
        pytest.approx(rep.profile.beta)


def test_tune_cli_then_serve_with_its_plan_cache(isolated_profiles, capsys):
    from repro_torch.tools import tune
    rc = tune.main(["--device", "cpu", "--hardware", "cpu_host", "--shape", "64,64,64",
                    "--reps", "1", "--quant", "--name", "cli_autotuned",
                    "--warm-workload", "granite_3_2b"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "wrote" in out and "FLOPS_int8" in out and "warmed plan cache" in out
    prof = thw.load_profile(thw.profile_path("cli_autotuned"), register=False)
    assert prof.name == "cli_autotuned" and prof.flops_mul > 0
    plans = isolated_profiles / "cli_autotuned.plans.json"
    n_warm = len(tpc.PlanCache(path=str(plans)))
    assert n_warm > 0
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "2",
         "--plan-cache", str(plans)], capture_output=True, text=True, env=ENV,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"plan cache: {n_warm} plans loaded from {plans}" in res.stdout
    # flushed back: the serve's own decisions join the warmed ones
    assert len(tpc.PlanCache(path=str(plans))) > n_warm
