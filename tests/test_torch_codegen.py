"""The port's Deployment Module (generated ``"torch"`` backend) against the
reference's generated ``"jnp"`` backend, on the CPU.

The same numpy inputs go through the reference's ``codegen.generate`` and
the port's, for every scheme in the library as Algorithm 2 (the reference's
``fused=True``, one batched GEMM) and Algorithm 1 (its ``fused=False`` with
the ``"loop"`` GEMM), with ``downcast_h`` and ``precombined_b``. Tolerances are the
reference's own: f32 rtol/atol 1e-4 (``tests/test_codegen.py``: the same
scheme, matmul sums in another order), bf16 0.15 against the exact product
(``tests/test_codegen.py``) and, stage by stage against the reference,
atol 6e-2 / rtol 2e-2 (``tests/test_kernels.py``: both add in bf16, XLA may
keep excess precision between fused adds). Then the backends' dense,
grouped and precombined calls, ``fused=False`` pricing (H in f32, where the
reference prices it in the operand dtype), and the autotuner's
``torch`` branch with its grouped-stage probe under the reference's
deterministic clock.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
import repro_torch.api as tfalcon
from repro.core import algorithms as jalg, autotune as jat, codegen as jcg
from repro.core import decision as jdec, falcon_gemm as jfg, hardware as jhw
from repro.core import plan_cache as jpc
from repro_torch.core import algorithms as talg, autotune as tat, codegen as tcg
from repro_torch.core import decision as tdec, falcon_gemm as tfg, hardware as thw
from repro_torch.core import plan_cache as tpc
from repro_torch.core.lcma import LCMA

from _schemes import mag2_111, mag2_scheme

SCHEMES = sorted(talg.library())
F32 = dict(rtol=1e-4, atol=1e-4)                 # tests/test_codegen.py
BF16_EXACT = dict(rtol=0.15, atol=0.15)          # tests/test_codegen.py::test_dtypes
BF16_STAGE = dict(atol=6e-2, rtol=2e-2)          # tests/test_kernels.py
COMPUTE_RICH = dict(name="codegen_compute_rich", flops_mul=2e12, flops_add=5e13,
                    beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
                    mxu_align=8, dtype_flops={"float32": 1e12},
                    lcma_gemm_efficiency=0.9)


@pytest.fixture(autouse=True)
def isolated_state(tmp_path, monkeypatch):
    """Both packages' profile registries and plan caches, restored."""
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


def _schemes(name):
    """(reference LCMA, port LCMA) with identical coefficients."""
    if name == "mag2":
        jl, j111 = mag2_scheme(), mag2_111()
        tl = talg.tensor_product(LCMA(j111.name, 1, 1, 1, 2, j111.U, j111.V, j111.W),
                                 talg.strassen(), "mag2-222")
    else:
        jl, tl = jalg.get(name), talg.get(name)
    assert jl.fingerprint == tl.fingerprint
    return jl, tl


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(l, rng, scale=8):
    A = rng.standard_normal((l.m * scale, l.k * scale)).astype(np.float32)
    B = rng.standard_normal((l.k * scale, l.n * scale)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("fused", [True, False])
def test_generated_matches_reference(name, fused, rng):
    jl, tl = _schemes(name)
    gemm_backend = "batched" if fused else "loop"
    jg = jcg.generate(jl, jcg.CodegenOptions(fused=fused, gemm_backend=gemm_backend))
    tg = tcg.generate(tl, tcg.CodegenOptions(gemm_backend=gemm_backend))
    A, B = _inputs(tl, rng)
    got = tg.fn(torch.tensor(A), torch.tensor(B))
    assert got.dtype == torch.float32 and tuple(got.shape) == (A.shape[0], B.shape[1])
    np.testing.assert_allclose(_np(got), A @ B, **F32)
    np.testing.assert_allclose(_np(got), _np(jg.fn(jnp.asarray(A), jnp.asarray(B))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["batched", "loop", "downcast_h"])
def test_dtypes_and_variants_match_reference(dtype, variant, rng):
    """Each stage of the generated pipeline against the reference's, in f32
    and bf16, and the result against the exact product."""
    opts = {"batched": {}, "loop": dict(gemm_backend="loop"),
            "downcast_h": dict(downcast_h=True)}[variant]
    jl, tl = _schemes("laderman")
    jg = jcg.generate(jl, jcg.CodegenOptions(fused=variant == "batched", **opts))
    tg = tcg.generate(tl, tcg.CodegenOptions(**opts))
    A, B = _inputs(tl, rng, scale=4)
    tA, tB = torch.tensor(A).to(getattr(torch, dtype)), torch.tensor(B).to(getattr(torch, dtype))
    jA, jB = jnp.asarray(A, dtype), jnp.asarray(B, dtype)
    tol = F32 if dtype == "float32" else BF16_STAGE
    stages = {}
    for side, g, a, b in (("t", tg, tA, tB), ("j", jg, jA, jB)):
        at, bt = g.stages["combine_a"](a), g.stages["combine_b"](b)
        h = g.stages["gemm"](at, bt)
        stages[side] = (at, bt, h, g.stages["combine_h"](h, a.dtype))
    for what, got, want in zip(("combine_a", "combine_b", "gemm", "combine_h"),
                               stages["t"], stages["j"]):
        assert tuple(got.shape) == tuple(want.shape), what
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what
        np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)
    h = stages["t"][2]
    assert h.dtype == (tA.dtype if variant == "downcast_h" else torch.float32)
    c = tg.fn(tA, tB)
    assert c.dtype == tA.dtype
    np.testing.assert_allclose(_np(c), A.astype(np.float32) @ B,
                               **(F32 if dtype == "float32" else BF16_EXACT))


@pytest.mark.parametrize("fused", [True, False])
def test_generated_honors_coefficient_magnitude(fused, rng):
    _, tl = _schemes("mag2")
    assert int(np.abs(tl.U).max()) > 1
    g = tcg.generate(tl, tcg.CodegenOptions(gemm_backend="batched" if fused else "loop"))
    A = rng.integers(-4, 4, (tl.m * 8, tl.k * 8)).astype(np.float32)
    B = rng.integers(-4, 4, (tl.k * 8, tl.n * 8)).astype(np.float32)
    np.testing.assert_array_equal(g.fn(torch.tensor(A), torch.tensor(B)).numpy(), A @ B)


@pytest.mark.parametrize("name", SCHEMES)
def test_source_has_no_runtime_coefficients(name):
    """Coefficients are literal terms: no coefficient array in the program,
    and exactly one term per nonzero coefficient (zeros pruned)."""
    _, tl = _schemes(name)
    src = tcg.generate(tl).source
    for forbidden in ("U[", "V[", "W[", "coeff[", "coeff_table", "np.", "tensor("):
        assert forbidden not in src, forbidden
    for prefix, nnz in (("at_", tl.nnz_u), ("bt_", tl.nnz_v)):
        lines = [ln for ln in src.splitlines() if ln.strip().startswith(prefix)]
        assert len(lines) == tl.R
        part = prefix[0]
        assert sum(len(re.findall(rf"\b{part}_\d+_\d+\b", ln)) for ln in lines) == nnz
    h_lines = [ln for ln in src.splitlines() if ln.strip().startswith("c_")]
    assert sum(ln.count("H[...") for ln in h_lines) == tl.nnz_w
    if name == "strassen":
        assert "at_0 = a_0_0 + a_1_1" in src


def test_source_is_cached_and_keyed_on_the_coefficients(rng):
    l = talg.get("strassen")
    assert tcg.generate(l) is tcg.generate(l)
    assert tcg.generate(l, tcg.CodegenOptions(gemm_backend="loop")) is not tcg.generate(l)
    assert tcg.generate(l, tcg.CodegenOptions()) is tcg.generate(l)
    # A scheme re-registered under the same name gets fresh code, not the
    # function generated for the old coefficients (the reference keys its
    # cache on the name alone).
    name = "codegen-reregistered"
    w = talg.strassen_winograd()
    first = LCMA(name, 2, 2, 2, 7, l.U, l.V, l.W)
    second = LCMA(name, 2, 2, 2, 7, w.U, w.V, w.W)
    try:
        talg.register(first)
        g1 = tcg.generate(talg.get(name))
        talg.register(second, overwrite=True)
        g2 = tcg.generate(talg.get(name))
    finally:
        talg.unregister(name)
    assert g1 is not g2 and g1.source != g2.source
    A, B = _inputs(second, rng, scale=4)
    np.testing.assert_allclose(g2.fn(torch.tensor(A), torch.tensor(B)).numpy(), A @ B, **F32)
    np.testing.assert_allclose(g2.stages["combine_a"](torch.tensor(A)).numpy(),
                               _np(jcg.generate(jalg.get("strassen-winograd"))
                                   .combine_a(jnp.asarray(A))), **F32)


def test_precombined_b_and_stagewise(rng):
    l = talg.get("laderman")
    g = tcg.generate(l, tcg.CodegenOptions(precombined_b=True))
    A, B = _inputs(l, rng, scale=4)
    bt = g.combine_b(torch.tensor(B))
    assert tuple(bt.shape) == (l.R, 4, 4)
    np.testing.assert_allclose(g.fn(torch.tensor(A), bt).numpy(), A @ B, **F32)
    g1 = tcg.generate(talg.get("strassen"), tcg.CodegenOptions(gemm_backend="loop"))
    A = rng.standard_normal((16, 16)).astype(np.float32)
    B = rng.standard_normal((16, 16)).astype(np.float32)
    at = g1.stages["combine_a"](torch.tensor(A))
    h = g1.stages["gemm"](at, g1.stages["combine_b"](torch.tensor(B)))
    np.testing.assert_allclose(g1.stages["combine_h"](h, torch.float32).numpy(), A @ B, **F32)


@pytest.mark.parametrize("name", ["strassen", "laderman", "s444", "mag2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True])
def test_combine_b_equals_precombine_weights(name, dtype, stacked, rng):
    """The generated Combine B has exactly the layout of the offline B̃ the
    kernels read, so one PlannedWeight serves on either backend."""
    _, tl = _schemes(name)
    shape = ((3,) if stacked else ()) + (tl.k * 6, tl.n * 5)
    w = torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, dtype))
    got = tcg.generate(tl).combine_b(w)
    want = tfg.precombine_weights(w, tl)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16_STAGE)


def _policy(mode="strassen", fused=True):
    """The reference's "jnp" under either of its pipelines, and the port's
    one generated backend."""
    return (jfg.FalconConfig(backend="jnp", mode=mode, fused=fused),
            tfg.FalconConfig(backend="torch", mode=mode))


@pytest.mark.parametrize("name", ["strassen", "s223", "laderman"])
@pytest.mark.parametrize("fused", [True, False])
def test_torch_backend_matches_jnp_backend(name, fused, rng):
    """Dense, grouped (shared and per-group B) and precombined calls through
    backend "torch" against the reference's "jnp", ragged shapes."""
    jc, tc = _policy(name, fused)
    a = rng.standard_normal((13, 23)).astype(np.float32)
    b = rng.standard_normal((23, 17)).astype(np.float32)
    a3 = rng.standard_normal((3, 13, 23)).astype(np.float32)
    b3 = rng.standard_normal((3, 23, 17)).astype(np.float32)
    w3 = rng.standard_normal((3, 23, 17)).astype(np.float32)
    T = torch.tensor
    with jfalcon.use(jc):
        jpw, jpw3 = jfalcon.plan_weight(jnp.asarray(b)), jfalcon.plan_weight(jnp.asarray(w3))
        want = {"dense": jfalcon.matmul(jnp.asarray(a), jnp.asarray(b)),
                "grouped_shared": jfalcon.grouped_matmul(jnp.asarray(a3), jnp.asarray(b)),
                "grouped": jfalcon.grouped_matmul(jnp.asarray(a3), jnp.asarray(b3)),
                "precombined": jfalcon.dense(jnp.asarray(a), jpw),
                "grouped_precombined": jfalcon.grouped_matmul(jnp.asarray(a3), jpw),
                "grouped_precombined_stacked": jfalcon.grouped_matmul(jnp.asarray(a3), jpw3)}
    calls = {}
    with tfalcon.use(tc):
        pw, pw3 = tfalcon.plan_weight(T(b)), tfalcon.plan_weight(T(w3))
        assert pw.precombined and pw3.precombined and pw3.bt.ndim == 4
        got = {"dense": tfalcon.matmul(T(a), T(b)),
               "grouped_shared": tfalcon.grouped_matmul(T(a3), T(b)),
               "grouped": tfalcon.grouped_matmul(T(a3), T(b3)),
               "precombined": tfalcon.dense(T(a), pw),
               "grouped_precombined": tfalcon.grouped_matmul(T(a3), pw),
               "grouped_precombined_stacked": tfalcon.grouped_matmul(T(a3), pw3)}
        # the generated code runs: no kernel wrapper is called
        from repro_torch import kernels as K
        calls = K.launch_counts()
    assert all(v == 0 for v in calls.values())
    exact = {"dense": a @ b, "grouped_shared": a3 @ b, "grouped": a3 @ b3,
             "precombined": a @ b, "grouped_precombined": a3 @ b,
             "grouped_precombined_stacked": a3 @ w3}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **F32)
        np.testing.assert_allclose(_np(got[k]), exact[k], err_msg=k, **F32)


def test_torch_backend_registered_with_the_cuda_int8_tier():
    be = tfalcon.get_backend("torch")
    assert "torch" in tfalcon.available_backends()
    assert be.apply_quant is tfalcon.get_backend("cuda").apply_quant
    # the pricing follows the pipeline each backend runs: H on chip on
    # "cuda", in memory on "torch"; it is no option of the policy
    assert tfg.FalconConfig().fused is True and be.fused is False
    assert tfg.FalconConfig(backend="torch").fused is False
    with pytest.raises(TypeError):
        tfg.FalconConfig(fused=False)


def _assert_h_in_f32(et, ej, groups=1):
    """The port's unfused estimate against the reference's in bf16: every
    stage the same but the product's and Combine H's bytes, which carry H in
    f32 (4 bytes an element) where the reference counts 2."""
    l = et.lcma
    Mp, Np, _ = et.padded_shape
    extra = groups * l.R * (Mp // l.m) * (Np // l.n) * (tdec.H_BYTES - 2)
    assert et.padded_shape == ej.padded_shape and l.name == ej.lcma.name
    assert [s.name for s in et.stages] == [s.name for s in ej.stages]
    for st, sj in zip(et.stages, ej.stages):
        assert st.flops == sj.flops, st.name
        assert st.bytes - sj.bytes == (extra if st.name in ("gemm", "combine_h") else 0), st.name


def _assert_decides_on_its_prices(d, min_speedup=1.02):
    """``decide`` takes the cheapest estimate when it wins by min_speedup."""
    if not d.estimates:
        assert d.algo is None
        return
    best = min(d.estimates, key=lambda e: e.time)
    if d.gemm_seconds / best.time >= min_speedup:
        assert d.algo is best.lcma and d.lcma_seconds == best.time
    else:
        assert d.algo is None


@pytest.mark.parametrize("profile", ["h100", "compute_rich"])
@pytest.mark.parametrize("precombined_b", [False, True])
def test_unfused_decisions_match_reference(profile, precombined_b):
    """Fused and unfused pricing, dense and grouped, against the reference's.
    In f32 (H in the operand dtype either way) they agree to the last bit;
    in bf16 the unfused estimates differ only by H's bytes."""
    fields = {"h100": dict(thw.H100_SXM.to_dict(), name="codegen_h100"),
              "compute_rich": COMPUTE_RICH}[profile]
    hj = jhw.register_profile(jhw.HardwareProfile(**fields))
    ht = thw.register_profile(thw.HardwareProfile(**fields))
    picked = set()
    for M, K, N in [(4, 2048, 512), (64, 256, 512), (256, 2048, 8192), (1000, 999, 1001),
                    (2048, 6144, 24576), (8192, 5120, 14336)]:
        for dtype in ("float32", "bfloat16"):
            for fused in (True, False):
                same = fused or dtype == "float32"
                dj = jdec.decide(M, N, K, hj, dtype, fused=fused,
                                 precombined_b=precombined_b, min_speedup=1.02)
                dt = tdec.decide(M, N, K, ht, dtype, fused=fused,
                                 precombined_b=precombined_b, min_speedup=1.02)
                assert len(dt.estimates) == len(dj.estimates)
                if same:
                    assert (dt.algo and dt.algo.name) == (dj.algo and dj.algo.name)
                    assert [[s.name for s in e.stages] for e in dt.estimates] == \
                        [[s.name for s in e.stages] for e in dj.estimates]
                    assert [e.time for e in dt.estimates] == \
                        pytest.approx([e.time for e in dj.estimates], rel=1e-12)
                else:
                    for et, ej in zip(dt.estimates, dj.estimates):
                        _assert_h_in_f32(et, ej)
                    _assert_decides_on_its_prices(dt)
                picked.add((fused, dt.algo.name if dt.algo else "gemm"))
                for B, shared in ((4, True), (16, False)):
                    gj = jdec.decide_batched(B, M, N, K, hj, dtype, fused=fused,
                                             precombined_b=precombined_b, shared_b=shared)
                    gt = tdec.decide_batched(B, M, N, K, ht, dtype, fused=fused,
                                             precombined_b=precombined_b, shared_b=shared)
                    if same:
                        assert (gt.algo and gt.algo.name) == (gj.algo and gj.algo.name)
                        assert [e.time for e in gt.estimates] == \
                            pytest.approx([e.time for e in gj.estimates], rel=1e-12)
                    else:
                        for et, ej in zip(gt.estimates, gj.estimates, strict=True):
                            _assert_h_in_f32(et, ej, groups=B)
                        _assert_decides_on_its_prices(gt, min_speedup=1.0)
        unfused = tdec.estimate(talg.get("strassen"), M, N, K, ht, "bfloat16", fused=False)
        assert [s.name for s in unfused.stages][-2:] == ["gemm", "combine_h"]
    if profile == "compute_rich":
        assert any(not f and p != "gemm" for f, p in picked)
    # plan() and plan_batched() price what the backend runs, under their own
    # keys: "torch" as the reference's fused=False, "cuda" as its fused=True
    for backend, fused in (("cuda", True), ("torch", False)):
        jc = jfg.FalconConfig(hardware=hj.name, backend="jnp", fused=fused)
        tc = tfg.FalconConfig(hardware=ht.name, backend=backend)
        for dtype in ("float32", "bfloat16"):
            dj = jfg.plan(2048, 6144, 24576, jc, dtype)
            dt = tfg.plan(2048, 6144, 24576, tc, dtype)
            if fused or dtype == "float32":
                assert dt.lcma_seconds == pytest.approx(dj.lcma_seconds, rel=1e-12) \
                    if dj.lcma_seconds else dt.lcma_seconds is None
            else:
                _assert_decides_on_its_prices(dt, tc.min_speedup)
                assert [e.time for e in dt.estimates] == pytest.approx(
                    [e.time for e in tdec.decide(2048, 24576, 6144, ht, dtype, fused=False,
                                                 min_speedup=tc.min_speedup).estimates],
                    rel=1e-12)
        gj = jfg.plan_batched(8, 64, 64, 80, jc, "float32")
        gt = tfg.plan_batched(8, 64, 64, 80, tc, "float32")
        assert (gt.algo and gt.algo.name) == (gj.algo and gj.algo.name)
    key = lambda f: tpc.plan_key(4, 8, 8, ht, "bfloat16", fused=f)  # noqa: E731
    assert "fused=0" in key(False) and "fused" not in key(True)


def model_timer(fn, *args):
    """Deterministic 'clock': seconds as a pure function of operand sizes
    (the reference's tests/test_autotune.py timer)."""
    return 1e-9 * sum(int(np.prod(a.shape)) for a in args) + 1e-6


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("group_size", [1, 4])
def test_autotune_torch_branch_matches_jnp_branch(quant, group_size):
    kw = dict(base="cpu_host", shapes=[(16, 16, 16), (32, 16, 32), (24, 40, 56)],
              timer=model_timer, validate=True, quant=quant, group_size=group_size)
    rj = jat.autotune(backend="jnp", **kw)
    rt = tat.autotune(backend="torch", device="cpu", **kw)
    for f in ("flops_mul", "flops_add", "beta", "lcma_gemm_efficiency"):
        assert getattr(rt.profile, f) == pytest.approx(getattr(rj.profile, f), rel=1e-12), f
    assert rt.profile.dtype_flops == rj.profile.dtype_flops
    assert rt.model_rel_err == pytest.approx(rj.model_rel_err, rel=1e-12)
    for f in ("eff_grouped", "eff_grouped_predicted", "flops_int8", "beta_quant"):
        want = getattr(rj, f)
        assert (getattr(rt, f) is None) if want is None else \
            getattr(rt, f) == pytest.approx(want, rel=1e-12), f
    assert (rt.eff_grouped is not None) == (group_size > 1)
    meta = rt.metadata()
    assert meta["backend"] == "torch" and "eff_grouped_predicted" in meta
    for p_t, p_j in zip(rt.probes, rj.probes, strict=True):
        got, want = p_t.as_dict(), p_j.as_dict()
        assert set(got) == set(want)
        assert got == pytest.approx(want, rel=1e-12)


def test_autotune_cuda_branch_skips_the_grouped_probe():
    rep = tat.autotune(base="cpu_host", backend="cuda", device="cpu", shapes=[(16, 16, 16)],
                       timer=model_timer)
    assert rep.eff_grouped is None and rep.probes[0].eff_grouped_est is None
    assert rep.probes[0].group_size == 4
    with pytest.raises(ValueError, match="'cuda' and 'torch'"):
        tat.autotune(base="cpu_host", backend="jnp", device="cpu", timer=model_timer)


def test_tune_cli_torch_backend(capsys):
    from repro_torch.tools import tune
    rc = tune.main(["--device", "cpu", "--hardware", "cpu_host", "--backend", "torch",
                    "--shape", "64,64,64", "--reps", "1", "--name", "cli_torch_autotuned",
                    "--no-warm"])
    out = capsys.readouterr().out
    assert rc == 0 and "via backend=torch" in out
    assert "grouped GEMM stage eff: measured" in out
    prof = thw.load_profile(thw.profile_path("cli_torch_autotuned"), register=False)
    assert prof.flops_mul > 0 and 0 < prof.lcma_gemm_efficiency <= 1
