"""``remat_policy="dots"`` in the port, against ``"full"``, no remat and the
reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

``lcma_smoke_config("granite_3_2b")`` cut to 4 layers, f32, forced
strassen, the reference's weights (``convert.params_from_numpy``):

* the loss and every gradient under ``dots``, ``full`` and no remat are
  equal within 1e-6 (relative Frobenius per leaf);
* ``dots`` keeps the outputs of the layers' 2-D products from the forward,
  so the recompute in backward runs none of them: counted at the fused
  kernel (#3, ``fused_gemm_combine_h``; on the CPU its plain version, so
  the count is taken at the pipeline's call of it), the backward under
  ``full`` runs every forward #3 product again, under ``dots`` only the LM
  head's (its cross-entropy chunk is a ``full`` remat block of its own);
* the port's ``dots`` gradients equal the reference's within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as jfalcon
from repro.configs.registry import lcma_smoke_config as j_smoke
from repro.models import model as JM
import repro_torch.api as tfalcon
from repro_torch.configs import lcma_smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves

LAYERS, B, S = 4, 2, 16
EQ_TOL = 1e-6
REF_TOL = 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def world():
    jcfg = dataclasses.replace(j_smoke("granite_3_2b"), num_layers=LAYERS, dtype="float32",
                               falcon_mode="strassen", falcon_backend="jnp", remat=True,
                               remat_policy="dots")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    np_batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return jcfg, np_params, np_batch


def _port(world, remat, policy, counter=None):
    """(loss, grads as numpy, #3 calls in forward, in backward)."""
    _, np_params, np_batch = world
    cfg = dataclasses.replace(t_smoke("granite_3_2b"), num_layers=LAYERS, dtype="float32",
                              falcon_mode="strassen", remat=remat, remat_policy=policy)
    params = params_from_numpy(np_params, cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    counter = counter or [0]
    with tfalcon.use(TM.falcon_config_for(cfg)):
        start = counter[0]
        loss, _ = TM.lm_loss(params, cfg, batch)
        fwd = counter[0] - start
        gs = torch.autograd.grad(loss, leaves)
        bwd = counter[0] - start - fwd
    by_id = {id(p): g for p, g in zip(leaves, gs)}
    grads = _flat(jax.tree.map(lambda p: by_id[id(p)].detach().numpy(), params,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    return float(loss.detach()), grads, fwd, bwd


@pytest.fixture()
def fused_calls(monkeypatch):
    """Counts the LCMA pipeline's calls of the fused kernel (#3)."""
    n = [0]
    orig = ops.fused_gemm_combine_h

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "fused_gemm_combine_h", counted)
    return n


def test_dots_full_and_no_remat_give_equal_grads(world):
    runs = {name: _port(world, remat, policy) for name, remat, policy in
            (("none", False, "full"), ("full", True, "full"), ("dots", True, "dots"))}
    want_loss, want = runs["none"][:2]
    for name in ("full", "dots"):
        loss, got = runs[name][:2]
        assert abs(loss - want_loss) <= EQ_TOL * abs(want_loss), name
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k], want[k]) <= EQ_TOL, (name, k)


def test_dots_recompute_runs_no_2d_product(world, fused_calls):
    _, _, fwd_full, bwd_full = _port(world, True, "full", fused_calls)
    _, _, fwd_dots, bwd_dots = _port(world, True, "dots", fused_calls)
    layer_products = LAYERS * 7                 # w_q, w_k, w_v, w_o, gate, up, down
    head = 1                                    # the tied LM head, one xent chunk
    assert fwd_full == fwd_dots == layer_products + head
    # backward: dA and dB of every product, plus the recomputed forward ones
    assert bwd_full == 2 * fwd_full + layer_products + head
    assert bwd_dots == 2 * fwd_dots + head
    assert bwd_full - bwd_dots == layer_products


def test_dots_grads_match_reference(world):
    jcfg, np_params, np_batch = world
    jb = {k: jax.numpy.asarray(v) for k, v in np_batch.items()}
    with jfalcon.use(JM.falcon_config_for(jcfg)):
        (jloss, _), jg = jax.value_and_grad(lambda p: JM.lm_loss(p, jcfg, jb), has_aux=True)(
            jax.tree.map(jax.numpy.asarray, np_params))
    loss, got, _, _ = _port(world, True, "dots")
    want = _flat(jax.tree.map(np.asarray, jg))
    assert abs(loss - float(jloss)) <= REF_TOL * abs(float(jloss))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= REF_TOL, k
