"""The port's public API (``repro_torch.api``) against the reference's.

``__all__`` is the reference's minus the names of work still to come
(none left since the multi-device slice); every name resolves. ``FalconEngine`` dispatches as the module-level functions do under
the same config; the compatibility forms and the deprecated shape shims
return what they wrap; the paper's metric ``effective_tflops`` (2MNK / t)
and its predicted form equal the reference's on the same profile.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.core import algorithms as jalg, decision as jdec, hardware as jhw
import repro_torch.api as tfalcon
from repro_torch.core import algorithms as talg, decision as tdec, hardware as thw
from repro_torch.core import workloads as twl
from repro_torch.core.hardware import H100_SXM

LATER: set[str] = set()


def test_all_is_the_reference_minus_later_work():
    assert set(tfalcon.__all__) == set(jfalcon.__all__) - LATER
    assert LATER <= set(jfalcon.__all__)
    assert len(tfalcon.__all__) == len(set(tfalcon.__all__))
    for name in tfalcon.__all__:
        assert getattr(tfalcon, name) is not None, name
    assert not LATER & set(dir(tfalcon))


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((3, 40, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    a3 = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(np.float32))
    b3 = torch.from_numpy(rng.standard_normal((4, 32, 24)).astype(np.float32))
    return x, w, a3, b3


@pytest.mark.parametrize("mode", ["strassen", "gemm"])
def test_engine_dispatch_equals_module_functions(mode):
    cfg = tfalcon.FalconConfig(mode=mode)
    eng = tfalcon.FalconEngine(cfg)
    x, w, a3, b3 = _operands()
    with tfalcon.use(cfg):
        want = dict(dense=tfalcon.dense(x, w), matmul=tfalcon.matmul(x[0], w),
                    grouped=tfalcon.grouped_matmul(a3, b3),
                    einsum=tfalcon.einsum("gmk,gkn->gmn", a3, b3),
                    dot=tfalcon.dot_general(a3, b3, (((2,), (1,)), ((0,), (0,)))),
                    plan=tfalcon.plan(256, 64, 48, cfg, "float32"),
                    batched=tfalcon.plan_batched(4, 16, 32, 24, cfg, "float32"))
        pw = tfalcon.plan_weight(w, m_hint=120)
        planned = tfalcon.dense(x, pw)
    got = dict(dense=eng.dense(x, w), matmul=eng.matmul(x[0], w),
               grouped=eng.grouped_matmul(a3, b3),
               einsum=eng.einsum("gmk,gkn->gmn", a3, b3),
               dot=eng.dot_general(a3, b3, (((2,), (1,)), ((0,), (0,)))),
               plan=eng.plan(256, 64, 48, "float32"),
               batched=eng.plan_batched(4, 16, 32, 24, "float32"))
    for k in ("dense", "matmul", "grouped", "einsum", "dot"):
        assert torch.equal(got[k], want[k]), k
    for k in ("plan", "batched"):
        assert got[k].algo == want[k].algo, k
    epw = eng.plan_weight(w, m_hint=120)
    assert (epw.algo, epw.precombined) == (pw.algo, pw.precombined)
    assert torch.equal(eng.dense(x, epw), planned)
    params, n = eng.precombine_params({"attn": {"w_q": w}}, m_hint=120)
    assert n == int(pw.precombined)
    with eng.activate():
        assert tfalcon.current_config() is cfg
        assert torch.equal(tfalcon.falcon_dense(x, w), want["dense"])
    assert torch.equal(tfalcon.falcon_dense(x, w, cfg), want["dense"])
    assert torch.equal(tfalcon.falcon_matmul(x[0], w, cfg), want["matmul"])
    assert eng.warm_buckets("granite_3_2b", [64]) == tfalcon.warm_buckets(
        cfg, "granite_3_2b", [64])


def test_shape_shims_warn_and_wrap_the_registry():
    with pytest.warns(DeprecationWarning, match="dense_projection_shapes"):
        got = tfalcon.projection_shapes("granite_3_2b")
    assert got == twl.dense_projection_shapes("granite_3_2b")
    with pytest.warns(DeprecationWarning, match="grouped_moe_shapes"):
        got = tfalcon.grouped_expert_shapes("dbrx_132b", 2048)
    assert got == twl.grouped_moe_shapes("dbrx_132b", 2048) != []


@pytest.mark.parametrize("scheme", [None, "strassen", "s444"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_effective_tflops_matches_reference(scheme, dtype):
    assert tdec.effective_tflops(2048, 8192, 2048, 1.7e-4) == \
        jdec.effective_tflops(2048, 8192, 2048, 1.7e-4)
    fields = dict(H100_SXM.to_dict(), name="api_parity_h100")
    hj = jhw.register_profile(jhw.HardwareProfile(**fields))
    ht = thw.register_profile(thw.HardwareProfile(**fields))
    lj = jalg.get(scheme) if scheme else None
    lt = talg.get(scheme) if scheme else None
    for M, N, K in [(2048, 8192, 2048), (4, 49408, 2048), (6144, 14336, 5120)]:
        assert tdec.predicted_effective_tflops(lt, M, N, K, ht, dtype) == pytest.approx(
            jdec.predicted_effective_tflops(lj, M, N, K, hj, dtype), rel=1e-12)
        # unfused pricing agrees in f32 only: the port carries H at the f32
        # accumulator's 4 bytes, the reference at the operand dtype's
        unfused = [dict(fused=False)] if dtype == "float32" else []
        for kw in [dict(precombined_b=True)] + unfused:
            if scheme:
                assert tdec.predicted_effective_tflops(lt, M, N, K, ht, dtype, **kw) == \
                    pytest.approx(jdec.predicted_effective_tflops(lj, M, N, K, hj, dtype,
                                                                  **kw), rel=1e-12)
