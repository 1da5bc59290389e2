"""The port's int8-compressed data-parallel mean and the ``shard_map_local``
hook, on real gloo ranks, against the reference's.

* ``compressed_psum_mean`` on 2 ranks against the reference's, run under
  ``conftest.run_multidevice(n_devices=2)`` inside ``shard_map`` on the
  same per-rank numpy gradients: bit-equal, and within 2e-2 (relative
  Frobenius) of the exact mean, the reference's bar
  (``tests/test_sharding.py``).
* The collectives' autograd forms on 2 ranks: each backward's gradient.
* The compressed-DP train step at warmup 1 on a fixed batch drops the loss
  by more than 0.05 in 8 steps (the reference's bar).
* The ``shard_map_local`` hook under ``fsdp_only`` on a 2 x 2 mesh, on the
  reference's shapes (x (16, 12, 48), w (48, 40), forced strassen): within
  1e-3 of numpy, its gradient within 1e-2, and within 1e-5 (relative to
  the largest output) of the reference's hook on a (4, 2) mesh of 8
  simulated devices. It declines
  where the replicated layout wins: with the FSDP layouts' pricing the
  batch-sharded layout always wins (it gathers a subset of the replicated
  layout's bytes and contracts 1/nb of its rows), so that case restricts
  the candidates to the replicated layout. The declined path is the
  ordinary planned dispatch on the same local rows (the reference hands it
  to GSPMD, which the port does not have), so its output is the same.

Rank bodies: ``tests/_torch_mesh_ranks.py``. Every ``run_ranks`` call
times out after ``TIMEOUT`` seconds.
"""
import jax
import numpy as np
import pytest

import _torch_mesh_ranks as ranks
from conftest import run_multidevice
from repro.configs.registry import smoke_config as j_smoke
from repro.models import model as JM
from repro_torch.configs import smoke_config
from repro_torch.parallel import mesh as PM

TIMEOUT = 120


def _ranks(tmp_path, fn, shape, *args):
    return PM.run_ranks(fn, shape, *args, device="cpu", workdir=str(tmp_path),
                        timeout=TIMEOUT)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_autograd_collectives(tmp_path):
    """reduce_scatter sums and keeps this rank's slice (of dim 0, and of
    dim 1 in bf16); the max all-reduce;
    all_gather's backward reduce-scatters (or slices) the gradient,
    copy_to_axis's sums it, the row-parallel all_reduce's passes it; a
    backward's collectives are counted under ``/bwd``."""
    out = _ranks(tmp_path, ranks.autograd_collectives_run, {"data": 2, "model": 1})
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["reduce_scatter"], (3 * x)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["reduce_scatter/dim1"], (3 * x.T)[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["max"], 2 * x)
        np.testing.assert_array_equal(o["gather/reduce_scatter"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(o["gather/slice"], np.full((2, 3), r + 1.0))
        np.testing.assert_array_equal(o["copy_to_axis"], np.full((2, 3), 3.0))
        z, g = o["all_reduce"]
        np.testing.assert_array_equal(z, 2 * np.arange(6).reshape(2, 3) + 10)
        np.testing.assert_array_equal(g, np.full((2, 3), r + 1.0))
        assert o["calls"] == {"reduce_scatter": 2, "all_reduce_max": 1, "all_gather": 2,
                              "reduce_scatter/bwd": 1, "all_reduce/bwd": 1, "all_reduce": 1}


@pytest.fixture(scope="module")
def grads_by_rank():
    rng = np.random.default_rng(0)
    return {"g": (rng.standard_normal((2, 8, 128)) * 0.01).astype(np.float32),
            "h": (rng.standard_normal((2, 33, 7)) * 3.0).astype(np.float32)}


def test_compressed_psum_mean_is_the_references(tmp_path, grads_by_rank):
    np.savez(tmp_path / "g.npz", **grads_by_rank)
    run_multidevice(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro import compat
        from repro.parallel.compression import compressed_psum_mean, psum_mean
        g = dict(np.load({str(tmp_path / 'g.npz')!r}))
        mesh = compat.make_mesh((2,), ("data",))

        def body(t):
            t = {{k: v[0] for k, v in t.items()}}
            return compressed_psum_mean(t, ("data",)), psum_mean(t, ("data",))
        spec = {{k: P("data") for k in g}}
        with compat.set_mesh(mesh):
            comp, exact = jax.jit(compat.shard_map(
                body, in_specs=(spec,), out_specs=({{k: P() for k in g}},) * 2,
                check_vma=False))({{k: jnp.asarray(v) for k, v in g.items()}})
        np.savez({str(tmp_path / 'ref.npz')!r},
                 **{{"comp_" + k: np.asarray(v) for k, v in comp.items()}},
                 **{{"exact_" + k: np.asarray(v) for k, v in exact.items()}})
    """, n_devices=2)
    ref = np.load(tmp_path / "ref.npz")
    out = _ranks(tmp_path, ranks.compressed_run, {"data": 2, "model": 1}, grads_by_rank)
    for r in out:
        for k in grads_by_rank:
            np.testing.assert_array_equal(r["comp"][k], ref["comp_" + k])
            np.testing.assert_allclose(r["exact"][k], ref["exact_" + k], rtol=1e-6, atol=0)
            assert _rel(r["comp"][k], r["exact"][k]) < 2e-2
    # one max all-reduce for both leaves' scales, one int32 sum for both
    calls = out[0]["stats"]["collective_calls"]
    assert calls["all_reduce_max"] == 1 and calls["all_reduce"] == 1 + len(grads_by_rank)


def test_compressed_dp_train_step_learns(tmp_path):
    cfg = smoke_config("granite_3_2b")
    jcfg = j_smoke("granite_3_2b")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    data_kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    out = _ranks(tmp_path, ranks.compressed_train_run, {"data": 2, "model": 1}, cfg,
                 np_params, data_kw, 8)
    losses = out[0]["losses"]
    assert out[1]["losses"] == losses                      # the mean, on every rank
    assert losses[-1] < losses[0] - 0.05, losses
    assert out[0]["calls"]["all_reduce_max"] == 8          # compressed every step


@pytest.fixture(scope="module")
def hook_inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((16, 12, 48)).astype(np.float32),
            rng.standard_normal((48, 40)).astype(np.float32))


@pytest.fixture(scope="module")
def hook_reference(hook_inputs, tmp_path_factory):
    """The reference's hook on a (4, 2) mesh of 8 simulated devices."""
    d = tmp_path_factory.mktemp("hook")
    np.savez(d / "xw.npz", x=hook_inputs[0], w=hook_inputs[1])
    run_multidevice(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro import compat
        from repro.core.falcon_gemm import FalconConfig, falcon_dense
        from repro.parallel import sharding as SH
        xw = np.load({str(d / 'xw.npz')!r})
        x, w = jnp.asarray(xw["x"]), jnp.asarray(xw["w"])
        mesh = compat.make_mesh((4, 2), ("data", "model"))
        SH.set_parallel_style("fsdp_only")
        cfg = FalconConfig(mode="strassen", backend="shard_map_local")
        with compat.set_mesh(mesh):
            out = jax.jit(lambda a, b: falcon_dense(a, b, cfg))(x, w)
        np.save({str(d / 'out.npy')!r}, np.asarray(out))
    """, n_devices=8)
    return np.load(d / "out.npy")


@pytest.mark.parametrize("restrict", [False, True], ids=["taken", "declined"])
def test_shard_map_local_hook(tmp_path, hook_inputs, hook_reference, restrict):
    x, w = hook_inputs
    out = _ranks(tmp_path, ranks.shard_map_local_run, {"data": 2, "model": 2}, x, w,
                 "strassen", restrict)
    got = np.concatenate([r["out"] for r in out], axis=0)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    assert np.max(np.abs(got - ref)) < 1e-3
    # within 1e-5 of the reference's, relative to the output's largest
    # magnitude (~20 here: an f32 ulp there is 1.9e-6)
    assert np.max(np.abs(got - hook_reference)) / np.max(np.abs(hook_reference)) < 1e-5
    g0 = 2 * np.einsum("btk,btn->kn", x.astype(np.float64), ref)
    for r in out:
        assert np.max(np.abs(r["grad"] - g0)) < 1e-2
        assert r["hook"] == ({"declined": 1} if restrict else {"taken": 1})
