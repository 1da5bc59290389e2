"""The port's planned autograd cores against the reference's custom VJPs.

The reference's dispatch core carries a ``jax.custom_vjp`` whose backward
computes ``dA = g Bᵀ`` and ``dB = Aᵀ g`` as independently planned falcon
contractions; the port's is a ``torch.autograd.Function`` per core
(``core/engine.py``). The same numpy inputs go through ``jax.grad`` of the
reference (backend ``"jnp"``) and through autograd of the port (backend
``"cuda"``, whose wrappers run their plain versions on the CPU, and the
generated ``"torch"``), held to the reference's ``TOL`` (f32 3e-4 / 3e-4;
bf16 against the gradient's scale, as ``tests/test_grads.py`` does).

On the CPU the kernels' plain versions are differentiable PyTorch, so
equal gradients alone would not show the cores ran: each case also finds
the port's ``autograd.Function`` node in the graph (``_cores``), and the
kernel wrappers refuse an operand that requires grad, so nothing reaches
them from autograd but a core.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.core import hardware as jhw, plan_cache as jpc
from repro.core.falcon_gemm import FalconConfig as JConfig
from repro.core.engine import PlannedWeight as JPW
import repro_torch.api as tfalcon
from repro_torch import kernels as K
from repro_torch.core import algorithms as talg, hardware as thw, plan_cache as tpc
from repro_torch.core.engine import PlannedWeight as TPW
from repro_torch.core.falcon_gemm import FalconConfig as TConfig

TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
       "bfloat16": dict(rtol=8e-2, atol=8e-2)}
FRIENDLY = dict(name="lcma_friendly_grads", flops_mul=1e12, flops_add=1e12, beta=1e15)
JFORCE = JConfig(mode="strassen", backend="jnp")
TFORCE = TConfig(mode="strassen")

CORES = {"_PlannedCoreBackward", "_GroupedCoreBackward", "_PlannedWeightCoreBackward",
         "_GroupedPlannedWeightCoreBackward", "_PlannedWeightRotatedCoreBackward",
         "_PlannedWeightQuantCoreBackward"}


@pytest.fixture(autouse=True)
def fresh_caches():
    jpc.reset()
    tpc.reset()
    yield
    jpc.reset()
    tpc.reset()


def _cores(out: torch.Tensor) -> set[str]:
    """The port's core nodes in ``out``'s autograd graph."""
    seen, stack, names = set(), [out.grad_fn], set()
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        stack += [m for m, _ in n.next_functions]
    return names & CORES


def _torch(x: np.ndarray, dtype: str, grad: bool = True) -> torch.Tensor:
    t = torch.from_numpy(np.array(x, dtype=np.float32)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


def _jax(x: np.ndarray, dtype: str):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _compare(got, want, dtype: str = "float32"):
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        if dtype == "bfloat16":
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=0.1, atol=0.05 * scale)
        else:
            np.testing.assert_allclose(g, w, **TOL[dtype])


def _both_grads(f_torch, f_jax, arrays, dtype="float32"):
    """Autograd of the port's scalar ``f_torch`` and ``jax.grad`` of the
    reference's ``f_jax`` w.r.t. every operand, on the same numpy inputs.
    Returns the port's output (for ``_cores``)."""
    ts = [_torch(a, dtype) for a in arrays]
    out, loss = f_torch(*ts)
    got = torch.autograd.grad(loss, ts)
    want = jax.grad(f_jax, tuple(range(len(arrays))))(*[_jax(a, dtype) for a in arrays])
    _compare(got, want, dtype)
    return out


# ---------------------------------------------------------------------------
# 2-D core: every candidate scheme, both backends, both dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", [l.name for l in talg.candidates()])
def test_grads_match_reference_for_every_candidate_scheme(scheme, rng):
    # grid-non-divisible shapes: the padding must differentiate too
    A, B = rng.standard_normal((13, 11)), rng.standard_normal((11, 9))
    tcfg, jcfg = TConfig(mode=scheme), JConfig(mode=scheme, backend="jnp")

    def f(a, b):
        out = tfalcon.matmul(a, b, cfg=tcfg)
        return out, torch.sin(out).sum()

    out = _both_grads(f, lambda a, b: jnp.sum(jnp.sin(jfalcon.matmul(a, b, cfg=jcfg))), (A, B))
    assert _cores(out) == {"_PlannedCoreBackward"}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_across_backends_and_dtypes(backend, dtype, rng):
    A, B = rng.standard_normal((27, 21)), rng.standard_normal((21, 24))
    tcfg = TConfig(mode="laderman", backend=backend)
    jcfg = JConfig(mode="laderman", backend="jnp")

    def f(a, b):
        out = tfalcon.matmul(a, b, cfg=tcfg)
        return out, (out.float() ** 2).sum()

    out = _both_grads(f, lambda a, b: jnp.sum(jfalcon.matmul(a, b, cfg=jcfg).astype(jnp.float32) ** 2),
                 (A, B), dtype=dtype)
    assert _cores(out) == {"_PlannedCoreBackward"}


DN_CASES = [
    ((20, 16), (16, 12), (((1,), (0,)), ((), ()))),          # canonical dense
    ((16, 20), (16, 12), (((0,), (0,)), ((), ()))),          # transposed lhs
    ((20, 16), (12, 16), (((1,), (1,)), ((), ()))),          # transposed rhs
    ((2, 3, 16, 12), (2, 3, 12, 8), (((3,), (2,)), ((0, 1), (0, 1)))),   # doubly batched
    ((3, 10, 16), (3, 16, 8), (((2,), (1,)), ((0,), (0,)))),            # single batch
]


@pytest.mark.parametrize("a_shape,b_shape,dn", DN_CASES)
def test_dot_general_grads_match_reference(a_shape, b_shape, dn, rng):
    a, b = rng.standard_normal(a_shape), rng.standard_normal(b_shape)

    def f(x, y):
        out = tfalcon.dot_general(x, y, dn, cfg=TFORCE)
        return out, torch.sin(out).sum()

    out = _both_grads(f, lambda x, y: jnp.sum(jnp.sin(jfalcon.dot_general(x, y, dn, cfg=JFORCE))),
                 (a, b))
    assert _cores(out) == ({"_GroupedCoreBackward"} if dn[1][0] else {"_PlannedCoreBackward"})


@pytest.mark.parametrize("subscripts,shapes", [
    ("bqhd,bkhd->bhqk", ((2, 8, 4, 16), (2, 8, 4, 16))),     # attention scores
    ("bhqk,bkhd->bqhd", ((2, 4, 8, 8), (2, 8, 4, 16))),      # attention values
])
def test_attention_einsum_grads_match_reference(subscripts, shapes, rng):
    a, b = (rng.standard_normal(s) for s in shapes)

    def f(x, y):
        out = tfalcon.einsum(subscripts, x, y, cfg=TFORCE)
        return out, (out ** 2).sum()

    out = _both_grads(f, lambda x, y: jnp.sum(jfalcon.einsum(subscripts, x, y, cfg=JFORCE) ** 2),
                 (a, b))
    assert _cores(out) == {"_GroupedCoreBackward"}


@pytest.mark.parametrize("shared", [True, False])
def test_grouped_core_grads_match_reference(shared, rng):
    """Shared B: dB is the flattened 2-D problem; per-group: a grouped one."""
    a = rng.standard_normal((3, 10, 16))
    b = rng.standard_normal((16, 12) if shared else (3, 16, 12))

    def f(x, y):
        out = tfalcon.grouped_matmul(x, y, cfg=TFORCE)
        return out, torch.sin(out).sum()

    out = _both_grads(f, lambda x, y: jnp.sum(jnp.sin(jfalcon.grouped_matmul(x, y, cfg=JFORCE))),
                 (a, b))
    assert _cores(out) == {"_GroupedCoreBackward"}


def test_grads_in_auto_mode_and_backward_plans_cached(rng):
    """Auto mode on a profile where LCMAs win: one train step leaves plans
    for BOTH backward shapes of each planned layer, in both packages."""
    thw.register_profile(thw.HardwareProfile(**FRIENDLY))
    jhw.register_profile(jhw.HardwareProfile(**FRIENDLY))
    tcfg = TConfig(mode="auto", hardware=FRIENDLY["name"])
    x, y = rng.standard_normal((64, 32)), rng.standard_normal((64, 16))
    w1, w2 = rng.standard_normal((32, 48)), rng.standard_normal((48, 16))
    params = {"w1": _torch(w1, "float32"), "w2": _torch(w2, "float32")}
    h = torch.tanh(tfalcon.dense(_torch(x, "float32", False), params["w1"], cfg=tcfg))
    out = tfalcon.dense(h, params["w2"], cfg=tcfg)
    loss = ((out - _torch(y, "float32", False)) ** 2).mean()
    assert _cores(out) == {"_PlannedCoreBackward"}
    got = torch.autograd.grad(loss, [params["w1"], params["w2"]])
    jcfg = JConfig(mode="auto", hardware=FRIENDLY["name"], backend="jnp")

    def jloss(p1, p2):
        hh = jax.nn.tanh(jfalcon.dense(jnp.asarray(x, jnp.float32), p1, cfg=jcfg))
        return jnp.mean((jfalcon.dense(hh, p2, cfg=jcfg) - jnp.asarray(y, jnp.float32)) ** 2)

    _compare(got, jax.jit(jax.grad(jloss, (0, 1)))(_jax(w1, "float32"), _jax(w2, "float32")))
    for cache in (tpc.default_cache(), jpc.default_cache()):
        for M, K, N in [(64, 32, 48), (64, 48, 16)]:
            assert cache.has_shape(M, K, N)
            for shape in tfalcon.backward_shapes(M, K, N):
                assert cache.has_shape(*shape), (M, K, N, shape)


def test_inference_prices_no_backward_shape(rng):
    """Without autograd recording (no_grad, inference_mode, or no operand
    requiring grad) no core runs and no backward shape is priced."""
    thw.register_profile(thw.HardwareProfile(**FRIENDLY))
    tcfg = TConfig(mode="auto", hardware=FRIENDLY["name"])
    x, w = _torch(rng.standard_normal((64, 32)), "float32"), _torch(
        rng.standard_normal((32, 48)), "float32")
    with torch.no_grad():
        tfalcon.dense(x, w, cfg=tcfg)
    with torch.inference_mode():
        tfalcon.dense(x, w, cfg=tcfg)
    tfalcon.dense(x.detach(), w.detach(), cfg=tcfg)
    cache = tpc.default_cache()
    assert cache.has_shape(64, 32, 48)
    assert not any(cache.has_shape(*s) for s in tfalcon.backward_shapes(64, 32, 48))
    tfalcon.dense(x, w, cfg=tcfg)
    assert all(cache.has_shape(*s) for s in tfalcon.backward_shapes(64, 32, 48))


def test_planned_vjp_false_raises_on_cuda_and_differentiates_through_on_torch(rng):
    """No silent detachment: the CUDA kernels have no backward, so without
    the cores a gradient through them is refused; the generated "torch"
    backend differentiates through its combine graph, as the reference's
    "jnp" does."""
    A, B = rng.standard_normal((12, 10)), rng.standard_normal((10, 8))
    off = dataclasses.replace(TFORCE, planned_vjp=False)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfalcon.matmul(_torch(A, "float32"), _torch(B, "float32"), cfg=off)
    with torch.no_grad():
        tfalcon.matmul(_torch(A, "float32"), _torch(B, "float32"), cfg=off)   # fine
    torch_off = dataclasses.replace(off, backend="torch")
    jcfg = dataclasses.replace(JFORCE, planned_vjp=False)

    def f(a, b):
        out = tfalcon.matmul(a, b, cfg=torch_off)
        return out, torch.sin(out).sum()

    out = _both_grads(f, lambda a, b: jnp.sum(jnp.sin(jfalcon.matmul(a, b, cfg=jcfg))), (A, B))
    assert _cores(out) == set()


def _wrapper_calls():
    l = talg.get("strassen")
    x = torch.randn(8, 8, requires_grad=True)
    at = torch.randn(7, 4, 4, requires_grad=True)
    aq, sa, sb = torch.zeros(7, 4, 4, dtype=torch.int8), torch.ones(7, 4, 1), torch.ones(7, 1, 4)
    return {
        "group_combine": lambda: K.group_combine(x, l.U),
        "batched_group_combine": lambda: K.batched_group_combine(x[None], l.U),
        "fused_gemm_combine_h": lambda: K.fused_gemm_combine_h(at, at, l.W),
        "batched_fused_gemm_combine_h": lambda: K.batched_fused_gemm_combine_h(
            at[None], at, l.W),
        "group_combine_quant": lambda: K.group_combine_quant(x, l.U, 4),
        "fused_gemm_combine_h_quant": lambda: K.fused_gemm_combine_h_quant(
            aq, sa.requires_grad_(), aq, sb, l.W),
        "tiled_matmul": lambda: K.tiled_matmul(x, x),
    }


@pytest.mark.parametrize("kernel", [k.__name__ for k in K.KERNELS])
def test_kernel_wrappers_refuse_an_operand_that_requires_grad(kernel):
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        call()


# ---------------------------------------------------------------------------
# PlannedWeight: raw, input, dropped (rotated), grouped, quantized; refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_planned_weight_raw_grad_matches_reference(backend, rng):
    W, x = rng.standard_normal((64, 48)), rng.standard_normal((8, 64))
    tcfg = dataclasses.replace(TFORCE, backend=backend)
    pw = tfalcon.plan_weight(_torch(W, "float32", False), cfg=tcfg, m_hint=256)
    assert pw.precombined
    pw.w.requires_grad_()
    pw.bt.requires_grad_()
    out = tfalcon.dense(_torch(x, "float32", False), pw, cfg=tcfg)
    assert _cores(out) == {"_PlannedWeightCoreBackward"}
    gw, gbt = torch.autograd.grad((out ** 2).sum(), [pw.w, pw.bt])
    jpw = jfalcon.plan_weight(_jax(W, "float32"), cfg=JFORCE, m_hint=256)
    want = jax.grad(lambda p: jnp.sum(jfalcon.dense(_jax(x, "float32"), p, cfg=JFORCE) ** 2))(jpw)
    _compare([gw], [want.w])
    # B̃ gets a zero gradient: the optimizer trains w, the refresh re-derives B̃
    assert float(gbt.abs().max()) == 0.0 == float(jnp.max(jnp.abs(want.bt)))


def test_planned_weight_input_grad_matches_reference(rng):
    W, x = rng.standard_normal((64, 48)), rng.standard_normal((4, 8, 64))
    pw = tfalcon.plan_weight(_torch(W, "float32", False), cfg=TFORCE, m_hint=256)
    jpw = jfalcon.plan_weight(_jax(W, "float32"), cfg=JFORCE, m_hint=256)

    def f(xx):
        out = tfalcon.dense(xx, pw, cfg=TFORCE)
        return out, (out ** 2).sum()

    out = _both_grads(f, lambda xx: jnp.sum(jfalcon.dense(xx, jpw, cfg=JFORCE) ** 2), (x,))
    assert _cores(out) == {"_PlannedWeightCoreBackward"}


def _dropped_pair(W, *, grouped=False):
    """The reference's dropped-weight PlannedWeight and the port's holding
    the same B̃ (requiring grad)."""
    jpw = jfalcon.plan_weight(_jax(W, "float32"), cfg=JFORCE, m_hint=256, keep_weight=False,
                              grouped=grouped)
    tpw = TPW(w=None, bt=_torch(np.asarray(jpw.bt), "float32"), algo=jpw.algo, k=jpw.k,
              n=jpw.n)
    return jpw, tpw


def test_planned_weight_dropped_raw_trains_bt_with_the_rotated_scheme(rng):
    """keep_weight=False: B̃ is the parameter; both gradients come from the
    rotated rank-R scheme (``_pw_bwd_rotated``, plain torch.einsum)."""
    W, x = rng.standard_normal((64, 48)), rng.standard_normal((8, 64))
    jpw, tpw = _dropped_pair(W)
    xt = _torch(x, "float32")
    out = tfalcon.dense(xt, tpw, cfg=TFORCE)
    assert _cores(out) == {"_PlannedWeightRotatedCoreBackward"}
    got = torch.autograd.grad((out ** 2).sum(), [xt, tpw.bt])
    want = jax.grad(lambda xx, p: jnp.sum(jfalcon.dense(xx, p, cfg=JFORCE) ** 2),
                    (0, 1))(_jax(x, "float32"), jpw)
    _compare(got, [want[0], want[1].bt])


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("keep_weight", [True, False])
def test_grouped_planned_weight_grads_match_reference(stacked, keep_weight, rng):
    """A PlannedWeight through grouped_matmul: shared (K, N) or a stack (G,
    K, N); the raw weight's planned grads, or the rotated scheme's."""
    a = rng.standard_normal((3, 8, 64))
    W = rng.standard_normal((3, 64, 48) if stacked else (64, 48))
    a_t = _torch(a, "float32")
    if keep_weight:
        jpw = jfalcon.plan_weight(_jax(W, "float32"), cfg=JFORCE, m_hint=256, grouped=stacked)
        tpw = tfalcon.plan_weight(_torch(W, "float32", False), cfg=TFORCE, m_hint=256,
                                  grouped=stacked)
        tpw.w.requires_grad_()
        leaf, jleaf, core = tpw.w, (lambda p: p.w), "_GroupedPlannedWeightCoreBackward"
    else:
        jpw, tpw = _dropped_pair(W, grouped=stacked)
        leaf, jleaf, core = tpw.bt, (lambda p: p.bt), "_PlannedWeightRotatedCoreBackward"
    out = tfalcon.grouped_matmul(a_t, tpw, cfg=TFORCE)
    assert _cores(out) == {core}
    got = torch.autograd.grad(torch.sin(out).sum(), [a_t, leaf])
    want = jax.grad(lambda x, p: jnp.sum(jnp.sin(jfalcon.grouped_matmul(x, p, cfg=JFORCE))),
                    (0, 1))(_jax(a, "float32"), jpw)
    _compare(got, [want[0], jleaf(want[1])])


def test_quantized_planned_weight_grads_are_fp_against_the_raw_weight(rng):
    """The quantized core's primal is the int8 pipeline; its backward is fp
    against the raw weight, so with a loss linear in the output the grads
    are those of the fp product, as the reference's ``_pw_quant_core``."""
    W, x, R = (rng.standard_normal(s) for s in ((64, 48), (8, 64), (8, 48)))
    tq = dataclasses.replace(TFORCE, quantize=True)
    jq = dataclasses.replace(JFORCE, quantize=True)
    tpw = tfalcon.plan_weight(_torch(W, "float32", False), cfg=tq, m_hint=256)
    jpw = jfalcon.plan_weight(_jax(W, "float32"), cfg=jq, m_hint=256)
    assert tpw.quantized and jpw.quantized
    xt, wt = _torch(x, "float32"), tpw.w.requires_grad_()
    tpw.b_scales.requires_grad_()
    out = tfalcon.dense(xt, tpw, cfg=tq)
    assert _cores(out) == {"_PlannedWeightQuantCoreBackward"}
    got = torch.autograd.grad((out * _torch(R, "float32", False)).sum(),
                              [xt, wt, tpw.b_scales])
    assert float(got[2].abs().max()) == 0.0

    def jloss(xx, ww):
        p = JPW(w=ww, bt=jpw.bt, algo=jpw.algo, k=jpw.k, n=jpw.n, bq=jpw.bq,
                b_scales=jpw.b_scales)
        return jnp.sum(jfalcon.dense(xx, p, cfg=jq) * _jax(R, "float32"))

    _compare(got[:2], jax.grad(jloss, (0, 1))(_jax(x, "float32"), _jax(W, "float32")))
    np.testing.assert_allclose(got[1].numpy(), x.T @ R, rtol=1e-4, atol=1e-4)


def test_refresh_planned_params_recombines(rng):
    W = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    pw = tfalcon.plan_weight(W, cfg=TFORCE, m_hint=256)
    moved = dataclasses.replace(pw, w=W * 2.0)          # the optimizer moved w; B̃ stale
    fresh = tfalcon.refresh_planned_params({"attn": {"w_q": moved}, "n": W})["attn"]["w_q"]
    torch.testing.assert_close(fresh.bt, pw.bt * 2.0, rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    torch.testing.assert_close(tfalcon.dense(x, fresh, cfg=TFORCE), x @ (W * 2.0),
                               rtol=1e-3, atol=1e-3)
    # the same B̃ as the reference's refresh of the same move
    jpw = jfalcon.plan_weight(jnp.asarray(W.numpy()), cfg=JFORCE, m_hint=256)
    jfresh = jfalcon.refresh_planned_params({"w": dataclasses.replace(jpw, w=jpw.w * 2.0)})["w"]
    np.testing.assert_allclose(fresh.bt.numpy(), np.asarray(jfresh.bt), rtol=1e-6, atol=1e-6)
    # quantized: B̃q and its scales re-baked at the same K-block
    tq = dataclasses.replace(TFORCE, quantize=True)
    qpw = tfalcon.plan_weight(W, cfg=tq, m_hint=256)
    qfresh = tfalcon.refresh_planned_params({"w": dataclasses.replace(qpw, w=W * 2.0)})["w"]
    want = tfalcon.plan_weight(W * 2.0, cfg=tq, m_hint=256)
    assert torch.equal(qfresh.bq, want.bq) and torch.equal(qfresh.b_scales, want.b_scales)
    # no raw weight, or no LCMA: passes through
    dropped = tfalcon.plan_weight(W, cfg=TFORCE, m_hint=256, keep_weight=False)
    assert tfalcon.refresh_planned_params({"w": dropped})["w"] is dropped


def test_sgd_through_a_planned_weight_tracks_eager(rng):
    """SGD through a PlannedWeight (planned backward + B̃ refresh each step)
    tracks raw-weight eager training (the reference's trajectory test)."""
    W, x, y = (rng.standard_normal(s).astype(np.float32) for s in ((64, 48), (32, 64), (32, 48)))
    x, y = torch.from_numpy(x), torch.from_numpy(y)

    def run(p, apply, refresh):
        losses = []
        for _ in range(5):
            p["w"] = tfalcon.refresh_planned_params(p)["w"] if refresh else p["w"]
            leaf = p["w"].w if refresh else p["w"]
            leaf.requires_grad_()
            loss = ((apply(p["w"]) - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [leaf])
            with torch.no_grad():
                leaf -= 0.05 * g
            losses.append(float(loss.detach()))
        return losses, leaf.detach()

    eager, w_eager = run({"w": torch.from_numpy(W.copy())}, lambda w: x @ w, False)
    pw = tfalcon.plan_weight(torch.from_numpy(W.copy()), cfg=TFORCE, m_hint=64)
    planned, w_planned = run({"w": pw}, lambda w: tfalcon.dense(x, w, cfg=TFORCE), True)
    np.testing.assert_allclose(planned, eager, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(w_planned, w_eager, rtol=1e-4, atol=1e-5)


def test_adamw_steps_planned_weight_params(rng):
    """PlannedWeight leaves ride through adamw_update + refresh: the planned
    layer's weight moves and the loss falls."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_map
    W, x, T = (rng.standard_normal(s).astype(np.float32) for s in ((64, 48), (32, 64), (64, 48)))
    x = torch.from_numpy(x)
    y = x @ torch.from_numpy(T)
    params = {"w_q": tfalcon.plan_weight(torch.from_numpy(W), cfg=TFORCE, m_hint=64)}
    opt_cfg = AdamWConfig(lr=3e-2, weight_decay=0.0)
    state = adamw_init(params, opt_cfg)

    def loss(p):
        return ((tfalcon.dense(x, p["w_q"], cfg=TFORCE) - y) ** 2).mean()

    first = None
    for _ in range(15):
        pw = params["w_q"]
        pw.w.requires_grad_()
        pw.bt.requires_grad_()
        val = loss(params)
        gw, gbt = torch.autograd.grad(val, [pw.w, pw.bt])
        grads = tree_map(lambda t: None, params)
        grads["w_q"] = dataclasses.replace(grads["w_q"], w=gw, bt=gbt)
        params, state, _ = adamw_update(params, grads, state, opt_cfg)
        params = tfalcon.refresh_planned_params(params)
        first = float(val.detach()) if first is None else first
    assert isinstance(params["w_q"], TPW)
    with torch.no_grad():
        assert float(loss(params)) < 0.6 * first


# ---------------------------------------------------------------------------
# Train-step warmup covers the step
# ---------------------------------------------------------------------------

def test_warm_train_covers_the_whole_step():
    """``steps.warm_train`` pre-plans every forward and backward triple a
    train step prices: the step after it adds no plan-cache entry."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.train.steps import loss_and_grads, warm_train

    thw.register_profile(thw.HardwareProfile(**FRIENDLY))
    cfg = smoke_config("granite_3_2b")
    with tfalcon.use(TConfig(mode="auto", hardware=FRIENDLY["name"])):
        n = warm_train(cfg, batch=2, seq=16)
        assert n > 0
        cache = tpc.default_cache()
        warmed = set(cache.keys())
        for K_, N_ in tfalcon.dense_projection_shapes(cfg):
            for shape in tfalcon.backward_shapes(2 * 16, K_, N_):
                assert cache.has_shape(*shape), (K_, N_)
        params = M.init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
        loss_and_grads(params, cfg, {"tokens": toks, "labels": toks})
        assert set(cache.keys()) == warmed
