"""The port's int8 tier against the reference, on the CPU.

On CPU tensors the int8 wrappers of ``repro_torch`` run their plain
versions (``kernels/ref.py``), which keep every f32 operation of the
reference's quantized Pallas kernels in the same order: Combine A summed
over the nonzero terms in ascending (i, l), ``s = max(amax / 127, 1e-12)``,
``q = clip(round_half_even(acc / s))``, and per K-block
``(int-product * a_scale) * b_scale``. The reference runs its Pallas kernels
in interpret mode on the same numpy inputs. So ``q`` is compared for
equality and the f32 results at 1e-6; where the two packages round in
different places (bf16 Combine B sums in bf16 in the reference, in f32 in
the port) one int8 step is allowed. The CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them to these plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.configs.registry import lcma_smoke_config as j_smoke
from repro.core import algorithms as jalg, hardware as jhw
from repro.core.engine import PlannedWeight as JPlannedWeight
from repro.kernels import ops as jops
from repro.kernels.quant_combine import (fused_gemm_combine_h_quant as j_fused_quant,
                                         group_combine_quant as j_combine_quant,
                                         quantize_b_blockwise as j_quantize_b)
from repro.models import model as JM
from repro.train.steps import make_decode_step, make_prefill_step
import repro_torch.api as tfalcon
from repro_torch import kernels as K
from repro_torch.analysis.stability import max_safe_accum_depth
from repro_torch.configs import lcma_smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithms as talg, hardware as thw
from repro_torch.core.engine import _quantize_weight
from repro_torch.core.lcma import LCMA
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quant_combine import launch_plan
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as TM

from _schemes import mag2_111, mag2_scheme

BF16_ULP = 2.0 ** -7          # one bf16 step, relative to the value


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


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _normalized(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# Kernels, one at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["strassen", "s223", "laderman", "mag2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_combine_quant_matches_pallas(name, dtype, rng):
    """Same inputs, same f32 operations in the same order: ``q`` is equal and
    the scales agree to the last bits. The scale is ``amax * f32(1/127)``,
    which is how the reference's XLA computes ``amax / 127``: with a true
    division the scale sometimes lands one ulp away, and a ``q`` that sits
    on a rounding boundary flips by one (1 in 10,752 for bf16 strassen)."""
    jl, tl = _schemes(name)
    # K-blocks of 32 and of 128 (granite's): on the card both take the
    # kernel's vector route (16-byte loads; one K-block over 4 and 16 bf16
    # lanes or 8 and 32 f32 ones)
    for X, Y, by in ((24, 64, 32), (8, 256, 128)):
        xj, xt = _pair(rng.standard_normal((jl.m * X, jl.k * Y)), dtype)
        assert launch_plan(xt, tl.U, by).route == "vector"
        qj, sj = j_combine_quant(xj, jl.U, block=(X, by), interpret=True)
        qt, st = K.group_combine_quant(xt, tl.U, by)
        assert qt.dtype == torch.int8 and tuple(qt.shape) == (tl.R, X, Y)
        assert st.dtype == torch.float32 and tuple(st.shape) == (tl.R, X, Y // by)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)


def test_group_combine_quant_rounds_half_to_even():
    """Exact halves after the division round to even, as ``jnp.round``."""
    l = talg.get("strassen")
    # one nonzero part: rank 0 of U sums parts (0,0) and (1,1); a row whose
    # absmax is 127 gives s = 1, so q is round(x)
    x = torch.zeros((2, 8))
    x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    q, s = K.group_combine_quant(x, l.U, by=4)
    r = int(np.flatnonzero((l.U[:, 0, 0] == 1) & (l.U[:, 1, 1] == 0))[0])
    assert s[r, 0, 0].item() == 1.0
    assert q[r, 0].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("name", ["strassen", "laderman", "mag2"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_fused_gemm_quant_matches_pallas(name, out_dtype, rng):
    """Identical int8 operands and scales. The int products are exact in
    both packages, the dequantization and Combine H run in the same order:
    f32 agrees at 1e-6 normalized, bf16 within one bf16 step."""
    jl, tl = _schemes(name)
    R = jl.R
    X, Y, Z, by = 32, 64, 48, 32
    aq = rng.integers(-127, 128, (R, X, Y)).astype(np.int8)
    bq = rng.integers(-127, 128, (R, Y, Z)).astype(np.int8)
    a_s = (rng.random((R, X, Y // by)) * 0.02 + 1e-3).astype(np.float32)
    b_s = (rng.random((R, Y // by, Z)) * 0.02 + 1e-3).astype(np.float32)
    want = j_fused_quant(jnp.asarray(aq), jnp.asarray(a_s), jnp.asarray(bq),
                         jnp.asarray(b_s), jl.W, block=(X, Z, by),
                         out_dtype=getattr(jnp, out_dtype), interpret=True)
    got = K.fused_gemm_combine_h_quant(torch.tensor(aq), torch.tensor(a_s),
                                       torch.tensor(bq), torch.tensor(b_s), tl.W,
                                       out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert tuple(got.shape) == tuple(want.shape) == (tl.m, tl.n, X, Z)
    if out_dtype == "float32":
        assert _normalized(got, want) <= 1e-6
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=1e-30)


@pytest.mark.parametrize("name,dtype", [(n, d) for n in ("strassen", "s223", "laderman")
                                         for d in ("float32", "bfloat16")
                                         if (n, d) != ("laderman", "bfloat16")])
def test_quantize_b_blockwise_matches_reference(name, dtype, rng):
    """Offline Combine B + int8 of a weight. f32: ``q`` equal. bf16: the
    reference's Combine B adds in bf16 and the port's in f32 and rounds
    once, so B̃ may be one bf16 step apart, and ``q`` one int8 step. That
    bound needs rank sums of at most two terms (strassen, s223): laderman's
    sums of up to seven terms round at every add in the reference, so its B̃
    strays further and it is held to the reference in f32 only."""
    jl, tl = _schemes(name)
    Y, Z, by = 64, 40, 16
    wj, wt = _pair(rng.standard_normal((jl.k * Y, jl.n * Z)), dtype)
    qj, sj = j_quantize_b(wj, jl.V, by=by, interpret=True)
    qt, st = K.quantize_b_blockwise(wt, tl.V, by=by)
    assert qt.dtype == torch.int8 and tuple(qt.shape) == (tl.R, Y, Z)
    assert tuple(st.shape) == (tl.R, Y // by, Z)
    if dtype == "float32":
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    else:
        assert np.abs(qt.numpy().astype(int) - np.asarray(qj).astype(int)).max() <= 1
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=BF16_ULP, atol=0)


def test_overflow_guard_raises_in_both_packages():
    """A K-block deeper than the int32-safe depth is refused before any
    kernel runs, in the reference and in the port alike."""
    by = max_safe_accum_depth(32) + 1
    w = np.ones((1, 1, 1), np.int8)
    aq, bq = np.zeros((1, 1, by), np.int8), np.zeros((1, by, 1), np.int8)
    s = np.ones((1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="overflows the int32 accumulator"):
        j_fused_quant(jnp.asarray(aq), jnp.asarray(s), jnp.asarray(bq), jnp.asarray(s),
                      w, interpret=True)
    with pytest.raises(ValueError, match="overflows the int32 accumulator"):
        K.fused_gemm_combine_h_quant(torch.tensor(aq), torch.tensor(s),
                                     torch.tensor(bq), torch.tensor(s), w)


def test_quant_wrappers_refuse_bad_operands():
    l = talg.get("strassen")
    with pytest.raises(ValueError, match="K-block"):
        K.group_combine_quant(torch.zeros(8, 12), l.U, by=4)       # Y = 6
    aq = torch.zeros((l.R, 4, 8), dtype=torch.int8)
    s = torch.ones((l.R, 4, 2))
    with pytest.raises(TypeError):
        K.fused_gemm_combine_h_quant(aq.float(), s, aq.transpose(1, 2).contiguous(),
                                     torch.ones((l.R, 2, 4)), l.W)
    with pytest.raises(ValueError, match="do not conform"):
        K.fused_gemm_combine_h_quant(aq, s, torch.zeros((l.R, 8, 4), dtype=torch.int8),
                                     torch.ones((l.R, 4, 4)), l.W)


# ---------------------------------------------------------------------------
# The ops pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_falcon_matmul_quant_matches_pallas_pipeline(dtype, rng):
    """Ragged (M, K, N), the same offline-quantized B̃q and scales fed to
    both pipelines (the A side is padded, combined and quantized by each)."""
    jl, tl = _schemes("strassen")
    M, Kd, N = 37, 150, 45                      # Y = 75, by = 25: three K-blocks
    aj, at = _pair(rng.standard_normal((M, Kd)), dtype)
    w = torch.tensor(rng.standard_normal((Kd, N)), dtype=torch.float32)
    bq, bs = _quantize_weight(w, tl, by=25)
    assert tuple(bq.shape) == (7, 75, 23) and tuple(bs.shape) == (7, 3, 23)
    want = jops.falcon_matmul_pallas_quant(aj, jnp.asarray(bq.numpy()),
                                           jnp.asarray(bs.numpy()), jl, N, interpret=True)
    got = tops.falcon_matmul_quant(at, bq, bs, tl, N)
    assert got.dtype == at.dtype and tuple(got.shape) == (M, N)
    assert _normalized(got, want) <= (1e-4 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("name", ["strassen", "s223"])
def test_int8_lcma_close_to_exact_product(name, rng):
    """Block-scaled int8 through the LCMA stays within 2% of A @ B, the
    reference's own bound (``tests/test_quant_kernels.py``); s223 pads N."""
    l = talg.get(name)
    a = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32)
    bq, bs = _quantize_weight(b, l, by=32)
    c = tops.falcon_matmul_quant(a, bq, bs, l, 128)
    exact = a.double() @ b.double()
    rel = ((c.double() - exact).norm() / exact.norm()).item()
    assert rel < 0.02, rel


def test_quantize_weight_slices_a_stack_like_its_layers(rng):
    """A stacked (L, K, N) leaf is quantized one layer at a time; each slice
    equals the leaf quantized on its own, and ``by`` divides Y."""
    l = talg.get("strassen")
    w = torch.tensor(rng.standard_normal((3, 40, 30)), dtype=torch.float32)
    bq, bs = _quantize_weight(w, l)
    assert tuple(bq.shape) == (3, 7, 20, 15) and tuple(bs.shape) == (3, 7, 1, 15)
    for i in range(3):
        q1, s1 = _quantize_weight(w[i], l)
        assert torch.equal(bq[i], q1) and torch.equal(bs[i], s1)
    q, s = _quantize_weight(torch.zeros(600, 8), l)
    assert q.shape[1] == 300 and 300 % (300 // s.shape[1]) == 0
    assert 300 // s.shape[1] == 100                   # largest divisor <= 128


# ---------------------------------------------------------------------------
# The slice as a whole: quantized one-shot serving against the reference
# ---------------------------------------------------------------------------

B, S, GEN = 2, 16, 5            # prefill + 4 decode steps
# the profile of tests/test_torch_model.py, under which LCMAs win at smoke shapes
PROFILE = dict(name="model_parity_profile", flops_mul=2e12, flops_add=5e13,
               beta=4e13, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
               mxu_align=8, dtype_flops=None, lcma_gemm_efficiency=1.0)
AUTO_CANDIDATES = ("strassen", "strassen-winograd", "s223")
# one int8 step is 1/127 of a block's absmax; a value on a rounding boundary
# may land on either side in the two packages
QUANT_TOL = 1e-2
REL_BUDGET = 0.15               # quant vs fp, as tests/test_quant_serve.py


def _n_quantized(tree) -> int:
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, JPlannedWeight))
    return sum(isinstance(x, JPlannedWeight) and x.quantized for x in leaves)


def _reference(mode: str):
    cfg = dataclasses.replace(j_smoke("granite_3_2b"), falcon_mode=mode,
                              falcon_backend="pallas_interpret")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    fcfg = dataclasses.replace(JM.falcon_config_for(cfg), quantize=True)
    if mode == "auto":
        jhw.register_profile(jhw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES)
    logits, tokens = [], []
    with jfalcon.use(fcfg):
        planned, n_pre = jfalcon.precombine_params(params, m_hint=B * S)
        prefill = jax.jit(make_prefill_step(cfg, max_len=S + GEN))
        decode = jax.jit(make_decode_step(cfg))
        lg, cache = prefill(planned, jnp.asarray(prompts, jnp.int32))
        for i in range(GEN):
            logits.append(np.asarray(lg[:, -1]))
            nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
            tokens.append(np.asarray(nxt))
            if i + 1 < GEN:
                lg, cache = decode(planned, cache, nxt[:, None], S + i)
    return (jax.tree.map(np.asarray, params), logits, np.stack(tokens, 1), n_pre,
            _n_quantized(planned))


@pytest.fixture(scope="module", params=["strassen", "auto"])
def served(request):
    """(mode, reference run, port quant run, port fp run on the same weights)."""
    mode = request.param
    np_params, logits, tokens, n_pre, n_q = _reference(mode)
    cfg = dataclasses.replace(t_smoke("granite_3_2b"), falcon_mode=mode)
    fcfg = TM.falcon_config_for(cfg)
    if mode == "auto":
        thw.register_profile(thw.HardwareProfile(**PROFILE))
        fcfg = dataclasses.replace(fcfg, hardware=PROFILE["name"],
                                   candidates=AUTO_CANDIDATES)
    runs = {}
    with tfalcon.use(fcfg):
        for quant in (True, False):
            params = params_from_numpy(np_params, cfg, device="cpu")
            runs[quant] = run_oneshot(cfg, batch=B, prompt_len=S, gen=GEN, seed=0,
                                      device="cpu", params=params, quantize=quant)
    return mode, (logits, tokens, n_pre, n_q), runs[True], runs[False]


def test_quant_serve_logits_match_reference(served):
    mode, (logits, _, _, _), res, _ = served
    assert len(res["logits"]) == len(logits) == GEN
    for step, (got, want) in enumerate(zip(res["logits"], logits)):
        e = _normalized(got, want)
        assert e <= QUANT_TOL, f"{mode} step {step}: {e}"


def test_quant_serve_counts_match_reference(served):
    mode, (_, _, n_pre, n_q), res, fp = served
    assert res["n_precombined"] == n_pre and res["n_quantized"] == n_q
    assert fp["n_quantized"] == 0
    if mode == "strassen":
        assert n_q == n_pre == 7
    else:
        assert n_q > 0         # the profile puts the int8 tier on the path


def test_quant_serve_greedy_tokens_match_where_decided(served):
    """A token must agree wherever the reference's top-2 margin exceeds twice
    the observed logit error, up to the first step where a near-tie let the
    two runs part."""
    mode, (logits, tokens, _, _), res, _ = served
    got = res["tokens"].numpy()
    checked = 0
    for b in range(B):
        for t in range(GEN):
            if not np.array_equal(got[b, :t], tokens[b, :t]):
                break
            want = logits[t][b]
            err = float(np.abs(res["logits"][t][b].numpy() - want).max())
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > 2 * err:
                assert got[b, t] == tokens[b, t], f"{mode} request {b} step {t}"
                checked += 1
    assert checked >= B


def test_port_quant_close_to_port_fp(served):
    """Prefix-matched relative logit error of int8 against fp serving on the
    same weights, as ``tests/test_quant_serve.py`` measures it."""
    mode, _, q, fp = served
    worst, compared = 0.0, 0
    for b in range(B):
        scale = max(float(lg[b].abs().max()) for lg in fp["logits"])
        for t in range(GEN):
            if not torch.equal(q["tokens"][b, :t], fp["tokens"][b, :t]):
                break
            err = float((q["logits"][t][b] - fp["logits"][t][b]).abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            compared += 1
    assert compared >= B
    assert 0 < worst <= REL_BUDGET, f"{mode}: {worst}"
