"""Tensor- and expert-parallel serving of the port, on real gloo ranks.

Each mesh test spawns its ranks as CPU processes
(``parallel.mesh.run_ranks``: a file store under ``tmp_path``, never a
fixed port) and runs a body of ``tests/_torch_mesh_ranks.py`` there.

* The reference's own acceptance bar (``tests/test_distributed.py``): the
  smoke granite engine (f32; 4 heads and 4 KV heads, so attention shards 2-
  and 4-way) serves 32 ragged requests on 2 and 4 ranks with the tokens of
  single-device serving and per-step logits within 1e-4, against the
  port's single device and against the reference's engine on the same
  weights; every rank serves the same, and adds no plan miss after warm.
* ``run_oneshot`` on 2 ranks against one device for the families
  (granite, dbrx's expert-parallel MoE, hymba with sharded and with
  whole-block attention, mamba2's whole SSD mixers under a sharded
  vocab, musicgen's codebook tables), and the launcher's ``--mesh``.
* One MoE layer expert-parallel over 2 and 4 ranks against the reference's
  dense layer, gemm and forced strassen.
* The decisions: a column-parallel leaf's equals the reference's under
  ``falcon_config_for(cfg, mesh_shape)``; a row-parallel one differs by
  design (the port contracts K / m and full N, the reference prices full K
  and N / m), pinned here.
* The refusals: a data axis, CUDA graphs on a gloo mesh, a mesh this
  process is not part of, nccl without a card per rank.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_ranks as ranks
import repro.api as jfalcon
import repro.serve as jserve
from repro.configs.registry import get_config as j_get, smoke_config as j_smoke
from repro.core import hardware as jhw, plan_cache as jcache
from repro.core.falcon_gemm import FalconConfig as JConfig, plan as jplan
from repro.models import model as JM, moe as jmoe
from repro_torch.configs import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import hardware as thw, plan_cache as tcache, workloads as twl
from repro_torch.core.falcon_gemm import plan as tplan
from repro_torch.launch.serve import run_oneshot
from repro_torch.models import model as TM
from repro_torch.parallel import mesh as PM
import repro_torch.serve as tserve

TOL = 1e-4
TIMEOUT = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(max_slots=4, max_prompt_len=16, max_new_tokens=4, record_logits=True)


def _ranks(tmp_path, fn, m, *args):
    return PM.run_ranks(fn, {"data": 1, "model": m}, *args, device="cpu",
                        workdir=str(tmp_path), timeout=TIMEOUT)


def _requests(vocab: int):
    """The reference acceptance test's 32 ragged requests."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(rng.integers(4, 17))) for _ in range(32)]
    return [(p, int(rng.integers(1, 5))) for p in prompts]


@pytest.fixture(scope="module")
def single_device():
    """The smoke granite engine in f32 on one device, port and reference,
    on one set of weights (the reference's init, as numpy)."""
    jcfg = dataclasses.replace(j_smoke("granite_3_2b"), dtype="float32", falcon_backend="jnp")
    tcfg = dataclasses.replace(t_smoke("granite_3_2b"), dtype="float32")
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    reqs = _requests(jcfg.vocab_size)
    jcache.reset()
    jeng = jserve.ServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **ENGINE_KW)
    jout = [jeng.submit(p, max_new_tokens=n) for p, n in reqs]
    jeng.run()
    tcache.reset()
    teng = tserve.ServeEngine(tcfg, params_from_numpy(np_params, tcfg, device="cpu"),
                              device="cpu", **ENGINE_KW)
    teng.warm()
    tout = [teng.submit(p, max_new_tokens=n) for p, n in reqs]
    teng.run()
    return tcfg, np_params, reqs, tout, jout


def _worst(got: list, want: list) -> float:
    return max(float(np.max(np.abs(np.stack(g) - np.stack(w)))) for g, w in zip(got, want))


@pytest.mark.parametrize("m", [2, 4])
def test_engine_on_a_mesh_matches_single_device(tmp_path, single_device, m):
    tcfg, np_params, reqs, tout, jout = single_device
    out = _ranks(tmp_path, ranks.engine_run, m, tcfg, np_params, reqs, ENGINE_KW)
    r0 = out[0]
    for other in out[1:]:           # SPMD: every rank serves the same
        assert other["tokens"] == r0["tokens"]
        assert _worst(other["logits"], r0["logits"]) == 0.0
    assert r0["tokens"] == [t.generated for t in tout] == [j.generated for j in jout]
    assert all(len(t) == n for t, (_, n) in zip(r0["tokens"], reqs))
    assert _worst(r0["logits"], [t.logits for t in tout]) < TOL
    assert _worst(r0["logits"], [j.logits for j in jout]) < TOL
    s = r0["summary"]
    assert s["requests_finished"] == 32 and s["bucket_misses"] == 0
    assert all(o["misses_after_warm"] == 0 for o in out)
    assert (s["mesh"], s["n_devices"], s["backend"], s["staged"]) == \
        ({"data": 1, "model": m}, m, "gloo", False)
    assert s["staged_bytes"] == 0 and s["collective_calls"]["all_reduce"] > 0
    assert s["collective_calls"]["all_gather"] > 0 and s["payload_bytes"] > 0


# The one-shot path over the families: (arch, config changes)
ONESHOT = {
    "granite": ("granite_3_2b", {}),
    "dbrx_ep": ("dbrx_132b", {}),
    "hymba_sharded": ("hymba_1_5b", {}),
    "hymba_whole_attention": ("hymba_1_5b", {"num_heads": 5, "num_kv_heads": 5,
                                             "head_dim": 16}),
    "mamba2": ("mamba2_370m", {}),
    "musicgen": ("musicgen_large", {}),
}


@pytest.mark.parametrize("case", list(ONESHOT))
def test_oneshot_on_two_ranks_matches_one_device(tmp_path, case):
    arch, changes = ONESHOT[case]
    cfg = dataclasses.replace(t_smoke(arch), dtype="float32", falcon_mode="strassen",
                              **changes)
    kw = dict(batch=2, prompt_len=8, gen=4, seed=3)
    one = run_oneshot(cfg, device="cpu", **kw)
    out = _ranks(tmp_path, ranks.oneshot_run, 2, cfg, kw)
    for r in out:
        np.testing.assert_array_equal(r["tokens"], one["tokens"].numpy())
        worst = max(float(np.max(np.abs(a - b.numpy())))
                    for a, b in zip(r["logits"], one["logits"]))
        assert worst < TOL, (case, worst)
        assert r["n_precombined"] == one["n_precombined"]
    calls = out[0]["mesh"]["collective_calls"]
    assert calls["all_gather"] > 0 and out[0]["mesh"]["backend"] == "gloo"
    # attention and MLP end in all-reduces except where a layer is held whole
    if case == "mamba2":        # only the embedding's per-step reduce
        assert calls["all_reduce"] == 1 + (kw["gen"] - 1)


def test_launcher_serves_on_a_mesh(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"}
    env.pop("RANK", None)
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
            "--device", "cpu", "--gen", "3"]
    outs = [subprocess.run(base + extra, capture_output=True, text=True, env=env,
                           timeout=TIMEOUT) for extra in ([], ["--mesh", "1,2"])]
    for o in outs:
        assert o.returncode == 0, o.stderr[-2000:]
    one, two = (o.stdout for o in outs)
    sample = lambda text: next(l for l in text.splitlines() if l.startswith("sample:"))  # noqa: E731
    assert sample(one) == sample(two)
    assert "backend gloo" in two and "staged bytes" in two
    assert two.count("sample:") == 1            # rank 0 prints, rank 1 is silent


MOE_CASES = [(m, mode) for m in (2, 4) for mode in ("gemm", "strassen")]


@pytest.mark.parametrize("m,mode", MOE_CASES)
def test_expert_parallel_layer_matches_reference_dense(tmp_path, m, mode):
    """smoke dbrx's widths with 8 experts (2 or 4 a rank), top-2."""
    c = j_smoke("dbrx_132b")
    d, ff, E, k, cf = c.d_model, c.d_ff, 8, c.experts_per_token, c.capacity_factor
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(5), d, ff, E, jnp.float32))
    x = np.random.default_rng(0).standard_normal((2, 16, d)).astype(np.float32)
    with jfalcon.use(JConfig(mode=mode, backend="jnp")):
        jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), top_k=k,
                                  capacity_factor=cf)
    out = _ranks(tmp_path, ranks.moe_layer_run, m, p, x, k, cf, mode)
    for r in out:
        assert r["held"] == E // m
        assert r["calls"] == {"all_gather": 1, "all_reduce": 1}
        np.testing.assert_allclose(r["y"], np.asarray(jy), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["aux"], float(jaux), rtol=1e-5)


@pytest.fixture()
def h100_in_both():
    """The port's h100_sxm registered in the reference under its name."""
    prof = thw.get_profile("h100_sxm")
    jhw.register_profile(jhw.HardwareProfile.from_dict(prof.to_dict()))
    yield prof
    jhw._PROFILES.pop("h100_sxm", None)


@pytest.mark.parametrize("M", [4, 256, 2048])
def test_column_parallel_decisions_match_reference_row_parallel_differ(h100_in_both, M):
    """granite at full width on a 1 x 2 mesh, auto mode, data sheet: the
    port plans each leaf at the shape its rank contracts; a column-parallel
    leaf's is the reference's under ``falcon_config_for(cfg, mesh_shape)``
    (full K, N / 2), a row-parallel one's is not (the port: K / 2, full N)."""
    cfg = get_config("granite_3_2b")
    mesh_shape = {"data": 1, "model": 2}
    jfc = dataclasses.replace(JM.falcon_config_for(j_get("granite_3_2b"), mesh_shape),
                              hardware="h100_sxm", mode="auto", enabled=True)
    tfc = dataclasses.replace(TM.falcon_config_for(cfg), mode="auto")
    assert tfc.shards == (1, 1, 1) and jfc.shards == (1, 1, 2)
    local = twl.resolve_contractions(cfg, 1, M, mesh_shape=mesh_shape, local=True)
    jcache.reset()
    tcache.reset()
    col, row = set(), set()
    for c in local:
        if c.kind != "dense" or c.role.startswith("ssm"):
            continue
        t = tplan(c.m, c.k, c.n, tfc, cfg.dtype, precombined_b=True)
        if c.role in ("attn.w_o", "mlp.down"):      # row-parallel: the recorded difference
            row.add(c.role)
            j = jplan(c.m, 2 * c.k, c.n, jfc, cfg.dtype, precombined_b=True)
            assert (t.M, t.K, t.N) == (c.m, c.k, c.n)
            assert (j.M, j.K, j.N) == (c.m, 2 * c.k, c.n // 2)
        else:                                       # column-parallel
            col.add(c.role)
            j = jplan(c.m, c.k, 2 * c.n, jfc, cfg.dtype, precombined_b=True)
            assert (t.M, t.K, t.N) == (j.M, j.K, j.N) == (c.m, c.k, c.n)
            assert (t.algo and t.algo.name) == (j.algo and j.algo.name)
            assert (t.gemm_seconds, t.lcma_seconds) == (j.gemm_seconds, j.lcma_seconds)
    # w_v shares w_k's shape, mlp.up mlp.gate's: one contraction each
    assert col == {"attn.w_q", "attn.w_k", "mlp.gate", "lm_head"}
    assert row == {"attn.w_o", "mlp.down"}


def test_a_data_axis_and_foreign_meshes_are_refused():
    cfg = t_smoke("granite_3_2b")
    with pytest.raises(NotImplementedError, match="6b"):
        tserve.ServeEngine(cfg, device="cpu", mesh_shape={"data": 2, "model": 1})
    with pytest.raises(NotImplementedError, match="6b"):
        run_oneshot(cfg, device="cpu", gen=1, mesh_shape={"data": 2, "model": 2})
    with pytest.raises(RuntimeError, match="belongs to no mesh"):
        tserve.ServeEngine(cfg, device="cpu", mesh_shape={"model": 2})
    with pytest.raises(RuntimeError, match="belongs to no mesh"):
        run_oneshot(cfg, device="cpu", gen=1, mesh_shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="nccl"):
        PM.init_mesh({"model": 2}, "nccl", rank=0, world_size=2, device="cpu")
    assert PM.choose_backend("cpu", 2) == "gloo"


def test_cuda_graphs_on_a_gloo_mesh_are_refused(tmp_path):
    msgs = _ranks(tmp_path, ranks.graphs_refused, 2, t_smoke("granite_3_2b"))
    assert all(m is not None and "cuda_graphs=False" in m for m in msgs)


def test_collectives_sum_and_concatenate_in_rank_order(tmp_path):
    out = _ranks(tmp_path, ranks.collectives_run, 2)
    xs = [o["torch.float32"][3] for o in out]
    for o in out:
        for dt in ("torch.float32", "torch.bfloat16"):
            red, cat_last, cat_first, _ = o[dt]
            np.testing.assert_array_equal(red, xs[0] + xs[1])
            np.testing.assert_array_equal(cat_last, np.concatenate(xs, axis=-1))
            np.testing.assert_array_equal(cat_first, np.concatenate(xs, axis=0))
        assert o["stats"]["collective_calls"] == {"all_reduce": 2, "all_gather": 4}
        assert o["stats"]["staged_bytes"] == 0 and o["stats"]["payload_bytes"] == 6 * (4 + 2) * 3
