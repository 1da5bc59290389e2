"""falcon-check of the port: discovery, the Hopper plan lint, the cache
audit, the CLI, the docs check, ``calibrate_cpu`` and the restores' default.

Every scenario here is static: no kernel is built or launched.

* ``core.discovery.discover`` is a numpy copy of the reference's: the same
  arguments and seed give the reference's U, V and W bit for bit.
* The plan lint (``analysis.plans``) re-derives each stage's shared memory,
  registers, threads and grid from the tiles through ``kernels.tuning``'s
  own formulas: clean on the shipped library and every arch's contraction
  set on ``h100_sxm``; an over-budget, a tampered, an illegal-dtype, a
  register-over-budget, a foreign-tile and an uncovered-split plan are
  flagged (the counterparts of ``tests/test_analysis.py``'s plan cases).
* The codegen lint re-derives the ``"torch"`` backend's generated combines
  from the AST: clean on every candidate and on a |c| > 1 scheme, and it
  catches a generator that drops magnitudes.
* The cache audit on a round-tripped cache of 2-D, grouped, sharded and
  int8 entries is clean; each corruption is flagged.
* The CLI exits 0 on the shipped library and 1 on each corrupted case.
* ``calibrate_cpu`` gives finite positive rates, is cached and resolves
  through ``get_profile``; restores default to the card.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _schemes import mag2_111 as j_mag2_111, mag2_scheme as j_mag2_scheme
from repro.core import algorithms as jalg, discovery as jdiscovery
from repro.core.lcma import LCMA as JLCMA
from repro_torch import analysis
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.configs import list_archs
from repro_torch.core import algorithms as alg, discovery, hardware, plan_cache
from repro_torch.core.falcon_gemm import FalconConfig, plan, plan_batched, plan_sharded
from repro_torch.core.lcma import LCMA
from repro_torch.kernels import tuning
from repro_torch.tools import check as check_cli, check_docs

H100 = hardware.H100_SXM
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(l) -> LCMA:
    return LCMA(l.name, l.m, l.k, l.n, l.R, l.U, l.V, l.W)


def _corrupt(l: LCMA, name="corrupt") -> LCMA:
    W = l.W.copy()
    W[0, 0, 0] += 1
    return LCMA(name, l.m, l.k, l.n, l.R, l.U, l.V, W)


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------

def _bad_strassen(cls):
    s = jalg.strassen()
    U = s.U.copy()
    U[0, 0, 1] = 1
    U[3, 1, 0] = -1
    return cls("corrupt", 2, 2, 2, 7, U, s.V, s.W)


DISCOVER = {
    "rank7_from_random": lambda cls: dict(restarts=30, als_iters=80, seed=2),
    "repair_corrupted": lambda cls: dict(restarts=3, als_iters=60, seed=0,
                                         init=_bad_strassen(cls)),
    "impossible_rank6": lambda cls: dict(restarts=3, als_iters=30, seed=0),
}


@pytest.mark.parametrize("case", list(DISCOVER))
def test_discover_matches_reference_bit_for_bit(case):
    R = 6 if case == "impossible_rank6" else 7
    want = jdiscovery.discover(2, 2, 2, R, **DISCOVER[case](JLCMA))
    got = discovery.discover(2, 2, 2, R, **DISCOVER[case](LCMA))
    if want is None:
        assert got is None
        return
    assert got is not None and got.name == want.name
    for f in "UVW":
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert not analysis.check_scheme(got)


# ---------------------------------------------------------------------------
# plan lint
# ---------------------------------------------------------------------------

SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (512, 2048, 1024), (8, 2048, 8192),
          (1, 64, 4096))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plan_lint_clean_on_h100(dtype):
    for l in alg.candidates():
        findings = analysis.lint_scheme_plans(l, SHAPES, H100, dtype=dtype)
        assert not analysis.has_errors(findings), (l.name, findings[:3])
        assert not analysis.has_errors(analysis.lint_quant_plans(l, SHAPES, H100))


def _plan(dtype="bfloat16", hw=H100):
    return tuning.block_plans(alg.strassen(), 1024, 1024, 1024, dtype=dtype, hw=hw)


def _errors(plan, hw=H100, **kw):
    kw.setdefault("dtype", "bfloat16")
    return [f for f in analysis.lint_block_plan(plan, hw, **kw) if f.is_error]


def test_plan_lint_flags_overbudget_plan():
    tiny = dataclasses.replace(H100, name="tiny_smem_test", vmem_bytes=1 << 12)
    errs = _errors(_plan(), tiny)
    assert errs and all(f.pass_name == "plan-lint" for f in errs)
    assert any("exceeds the profile limit 4096 B" in f.message for f in errs)


@pytest.mark.parametrize("key", ["combine_a_smem_bytes", "combine_b_smem_bytes",
                                 "fused_gemm_smem_bytes", "fused_gemm_tc_smem_bytes",
                                 "quant_combine_a_smem_bytes", "fused_gemm_quant_smem_bytes"])
def test_plan_lint_flags_tampered_report(key):
    plan = _plan()
    assert not _errors(plan)
    plan[key] += 16
    assert any("stale or hand-edited" in f.message for f in _errors(plan))


def test_plan_lint_flags_illegal_dtype():
    errs = _errors(_plan("float64"), dtype="float64", backend="cuda")
    assert any("not executable on backend 'cuda'" in f.message for f in errs)
    assert not _errors(_plan("float64"), dtype="float64", backend="torch")


def test_plan_lint_flags_registers_over_budget(monkeypatch):
    plan = _plan()
    monkeypatch.setattr(tuning, "REGS_PER_THREAD", 96)      # a smaller register file
    errs = _errors(plan)
    assert any("registers a thread > 96" in f.message for f in errs)


def test_plan_lint_flags_tiles_and_splits_the_kernels_lack():
    plan = _plan()
    plan["fused_gemm_tc"] = {**plan["fused_gemm_tc"], "bx": 48}
    assert any("not a tensor-core tile" in f.message for f in _errors(plan))
    plan = tuning.block_plans(alg.strassen(), 8, 2048, 8192, dtype="bfloat16", hw=H100)
    tc = plan["fused_gemm_tc"]
    assert tc["splits"] > 1 and not _errors(plan)
    plan["fused_gemm_tc"] = {**tc, "splits": tc["units"] + 1}
    assert any("do not cover" in f.message for f in _errors(plan))
    plan = _plan()
    plan["quant_combine_a"] = {**plan["quant_combine_a"], "by": 7}
    assert any("scale block" in f.message for f in _errors(plan))


def test_quant_lint_flags_backend_and_accumulator():
    l = alg.strassen()
    errs = [f for f in analysis.lint_quant_plans(l, SHAPES[:1], H100,
                                                 backend="shard_map_local") if f.is_error]
    assert any("int8 is not executable" in f.message for f in errs)
    errs = [f for f in analysis.lint_quant_plans(l, SHAPES[:1], H100, acc_bits=16)
            if f.is_error]
    assert any("overflow" in f.message for f in errs)


def test_tiled_and_grouped_plans_lint_clean_and_align():
    for M, K, N in ((4096, 2048, 8192), (8, 2048, 2048), (33, 100, 70)):
        for dtype in ("bfloat16", "float32"):
            assert not analysis.has_errors(analysis.lint_tiled_plan(M, K, N, H100, dtype=dtype))
    odd = dataclasses.replace(H100, name="align96", mxu_align=96)
    assert any("multiple" in f.message
               for f in analysis.lint_tiled_plan(4096, 2048, 8192, odd) if f.is_error)
    assert not analysis.has_errors(
        analysis.lint_grouped_plan(alg.strassen(), 384, 64, 7168, 2048, H100, shared_b=False))


@pytest.mark.parametrize("arch", list_archs())
def test_workload_lint_clean_on_h100(arch):
    findings = analysis.lint_workload(arch, H100, quantize=False)
    findings += analysis.lint_workload(arch, H100, quantize=True, batch=4, seq=256)
    assert not analysis.has_errors(findings), findings[:3]


def test_codegen_lint_clean_and_catches_a_magnitude_drop(monkeypatch):
    for l in alg.candidates():
        assert analysis.lint_codegen(l) == [], l.name
    assert analysis.lint_codegen(_port(j_mag2_scheme())) == []
    from repro_torch.core import codegen

    l = _port(j_mag2_111())
    stripped = LCMA("mag2-dropped", 1, 1, 1, 2, np.sign(l.U), np.sign(l.V), np.sign(l.W))
    orig = codegen._emit_source
    monkeypatch.setattr(codegen, "_emit_source", lambda scheme, o: orig(stripped, o))
    errs = [f for f in analysis.lint_codegen(l) if f.is_error]
    assert errs and all(f.pass_name == "codegen-lint" for f in errs)


# ---------------------------------------------------------------------------
# cache audit
# ---------------------------------------------------------------------------

@pytest.fixture
def saved_cache(tmp_path):
    """A cache of 2-D, grouped, sharded and int8 decisions on ``h100_sxm``,
    saved and restored to the process cache after."""
    plan_cache.reset()
    cfg = FalconConfig(mode="auto", hardware="h100_sxm")
    plan(4096, 4096, 4096, cfg)
    plan(8192, 2048, 8192, dataclasses.replace(cfg, quantize=True))
    plan_batched(64, 512, 2048, 2048, cfg, shared_b=True)
    plan_sharded(8192, 4096, 8192, cfg, n_devices=4)
    path = plan_cache.default_cache().save(str(tmp_path / "cache.json"))
    plan_cache.reset()
    return path


def _entries(path):
    return json.loads(open(path).read())["entries"]


def test_cache_audit_clean_roundtrip(saved_cache):
    entries = _entries(saved_cache)
    assert any("B" in p for _, p in entries) and any("ly" in p for _, p in entries)
    assert any("quant=1" in k for k, _ in entries)
    findings = analysis.audit_cache_file(saved_cache, hw=H100)
    assert not analysis.has_errors(findings), findings


def _first(entries, pred):
    return next(p for k, p in entries if pred(k, p))


CORRUPTIONS = {
    "dangling_scheme": (lambda es: _first(es, lambda k, p: True).update(
        algo="ghost-scheme", algo_fp="0" * 12, lcma_seconds=1e-5), "ghost-scheme"),
    "definition_drift": (lambda es: _first(es, lambda k, p: True).update(
        algo="strassen", lcma_seconds=1e-5, algo_fp="f" * 12), "definition changed"),
    "shape_mismatch": (lambda es: _first(es, lambda k, p: "B" not in p).update(M=999),
                       "shape token"),
    "grouped_b": (lambda es: _first(es, lambda k, p: "B" in p).update(B=63), "shape token"),
    "sharded_devices": (lambda es: _first(es, lambda k, p: "ly" in p).update(D=8),
                        "priced for D=4"),
    "quant_token": (lambda es: _first(es, lambda k, p: "quant=1" not in k).update(
        prec="int8"), "quant=1"),
    "negative_timing": (lambda es: _first(es, lambda k, p: True).update(gemm_seconds=-1.0),
                        "not a finite"),
    "duplicate_key": (lambda es: es.append(list(es[0])), "duplicate cache key"),
}


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_cache_audit_flags_corruption(saved_cache, case):
    doc = json.loads(open(saved_cache).read())
    corrupt, msg = CORRUPTIONS[case]
    corrupt(doc["entries"])
    json.dump(doc, open(saved_cache, "w"))
    errs = [f for f in analysis.audit_cache_file(saved_cache, hw=H100) if f.is_error]
    assert errs and all(f.pass_name == "cache-audit" for f in errs)
    assert any(msg in f.message for f in errs), errs


def test_cache_audit_warns_on_a_recalibrated_profile(saved_cache):
    recal = dataclasses.replace(H100, beta=3.0e12)
    warns = [f for f in analysis.audit_cache_file(saved_cache, hw=recal)
             if f.severity == "warning"]
    assert warns and all("stale" in f.message for f in warns)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_all_clean_on_shipped_library(capsys):
    assert check_cli.main(["--all"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out


def test_cli_exit_codes_on_corrupted_inputs(tmp_path, saved_cache, capsys):
    l = _corrupt(alg.strassen(), name="strassen-corrupt")
    p = tmp_path / "bad_scheme.json"
    p.write_text(json.dumps(dict(name=l.name, m=l.m, k=l.k, n=l.n, R=l.R, U=l.U.tolist(),
                                 V=l.V.tolist(), W=l.W.tolist())))
    assert check_cli.main(["--scheme-file", str(p)]) == 1
    assert "Brent equations violated" in capsys.readouterr().out
    assert check_cli.main(["--quant-accum", "128,16"]) == 1
    assert "overflow" in capsys.readouterr().out
    hardware.register_profile(dataclasses.replace(H100, name="tiny_smem_cli",
                                                  vmem_bytes=1 << 12))
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(_plan()))
    assert check_cli.main(["--plan-file", str(p), "--dtype", "bfloat16"]) == 0
    assert check_cli.main(["--plan-file", str(p), "--dtype", "bfloat16",
                           "--hardware", "tiny_smem_cli"]) == 1
    assert "plan-lint" in capsys.readouterr().out
    doc = json.loads(open(saved_cache).read())
    doc["entries"][0][1].update(algo="ghost-scheme", lcma_seconds=1e-5)
    json.dump(doc, open(saved_cache, "w"))
    assert check_cli.main(["--cache", saved_cache]) == 1
    out = capsys.readouterr().out
    assert "cache-audit" in out and "ghost-scheme" in out
    assert check_cli.main(["--scheme", "strassen", "--workload", "granite_3_2b"]) == 0


def test_check_docs_runs_the_port_section_and_flags_faults(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.tools.check_docs"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:]
    assert "python block(s) ok, links ok" in out.stdout
    assert len(check_docs.extract_python_blocks(
        check_docs.section(open(os.path.join(REPO, "README.md")).read(),
                           check_docs.PORT_SECTION))) >= 1
    bad = tmp_path / "bad.md"
    bad.write_text("# t\n\n[x](missing.md)\n\n```python\ny = falcon.dense(x, w)\n"
                   "assert y.shape == (2, 16, 64)\nraise ValueError('boom')\n```\n")
    out = subprocess.run([sys.executable, "-m", "repro_torch.tools.check_docs", str(bad)],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 1
    assert "broken link -> missing.md" in out.stdout and "boom" in out.stdout


# ---------------------------------------------------------------------------
# calibrate_cpu and the restores' default
# ---------------------------------------------------------------------------

def test_calibrate_cpu_is_finite_positive_cached_and_resolvable():
    prof = hardware.calibrate_cpu(256)
    for f in ("flops_mul", "flops_add", "beta"):
        v = getattr(prof, f)
        assert np.isfinite(v) and v > 0, (f, v)
    assert 0 < prof.lcma_gemm_efficiency <= 1.0
    assert prof.flops_add == prof.beta / 4
    assert hardware.calibrate_cpu(256) is prof
    assert hardware.get_profile("cpu_host_calibrated") is prof
    assert prof.name == "cpu_host_calibrated" and prof.vmem_bytes == hardware.CPU_HOST.vmem_bytes


def test_restores_default_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("the default is exercised where no card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), {"a": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path)).restore_latest({"a": None})
