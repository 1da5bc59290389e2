"""A data axis in serving, on real gloo ranks.

Each mesh spawns its ranks as CPU processes (``parallel.mesh.run_ranks``, a
file store under ``tmp_path``) and runs bodies of ``tests/_torch_mesh_ranks.py``
there, several a spawn (``suite``). Everything is float32, and the
tolerance is the reference's multi-device bar (``tests/test_distributed.py``):
equal greedy tokens and per-step logits within ``TOL`` = 1e-4.

* The continuous engine on ``{"data": 2}`` and ``{"data": 2, "model": 2}``
  for smoke granite (dense), dbrx (MoE) and mamba2 (SSM): 16 ragged
  requests in two waves (the second resubmits and extends prompts of the
  first, so the prefix cache hits), chunked prefill on. Every rank serves
  the same, equal to the port's single device and to the reference's
  single-device engine on the same weights (the reference's init), and
  adds no plan-cache miss after ``warm()``.
* A micro-batch of one row on two data ranks (the other rank computes only
  pad rows and still joins the gather); speculation on ``{"data": 2}``
  (the draft runs each whole micro-batch on every rank) against one device.
* ``run_oneshot`` on ``{"data": 2}`` for every family against one device;
  a batch that does not split is refused; the launcher's ``--mesh 2,1``.
* ``all_gather_rows`` packs tensors of several dtypes into one message.

dbrx runs at its smoke config's own capacity_factor (1.25), where the
capacity binds and tokens drop: a data rank's MoE layers route as one
device routes the whole step (``models.moe.route_over_data``), so the same
tokens drop on every mesh.
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
import repro.serve as jserve
from repro.configs.registry import smoke_config as j_smoke
from repro.core import plan_cache as jcache
from repro.models import model as JM
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import plan_cache as tcache, workloads as twl
from repro_torch.launch.serve import run_oneshot
from repro_torch.parallel import mesh as PM
import repro_torch.serve as tserve

TOL = 1e-4
TIMEOUT = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_slots=8, max_prompt_len=16, max_new_tokens=4, record_logits=True,
          prefix_cache=True, prefill_chunk=8)
ARCHS = {"granite": ("granite_3_2b", {}), "dbrx": ("dbrx_132b", {}),
         "mamba2": ("mamba2_370m", {})}
ONESHOT = {"granite": ("granite_3_2b", {}), "dbrx": ("dbrx_132b", {}),
           "mamba2": ("mamba2_370m", {}), "hymba": ("hymba_1_5b", {}),
           "musicgen": ("musicgen_large", {}), "pixtral": ("pixtral_12b", {})}
ONESHOT_KW = dict(batch=4, prompt_len=8, gen=3)
MESHES = {"d2": (2, 1), "d2m2": (2, 2)}
SPEC_KW = {**KW, "speculate": 2}


def _cfgs(arch, changes):
    t = dataclasses.replace(t_smoke(arch), dtype="float32", **changes)
    j = dataclasses.replace(j_smoke(arch), dtype="float32", falcon_backend="jnp", **changes)
    return t, j


def _waves(vocab: int):
    """16 ragged requests in two waves of 8: the second wave resubmits
    three prompts of the first and extends two more."""
    rng = np.random.default_rng(3)
    first = [rng.integers(0, vocab, int(rng.integers(4, 17))) for _ in range(8)]
    second = [first[0], first[3], first[5],
              np.concatenate([first[1][:6], rng.integers(0, vocab, 5)]),
              np.concatenate([first[2], rng.integers(0, vocab, 2)])[:16]]
    second += [rng.integers(0, vocab, int(rng.integers(1, 17))) for _ in range(3)]
    return [[(p, int(rng.integers(1, 5))) for p in wave] for wave in (first, second)]


@pytest.fixture(scope="module")
def cases():
    """Per arch: the port config, the reference's init as numpy, the
    waves, and what one device serves (port and reference engines)."""
    out = {}
    for name, (arch, changes) in ARCHS.items():
        tcfg, jcfg = _cfgs(arch, changes)
        np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
        waves = _waves(tcfg.vocab_size)
        jcache.reset()
        jeng = jserve.ServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **KW)
        jout = ranks.serve_waves(jeng, waves)
        tcache.reset()
        teng = tserve.ServeEngine(tcfg, params_from_numpy(np_params, tcfg, device="cpu"),
                                  device="cpu", **KW)
        teng.warm()
        tout = ranks.serve_waves(teng, waves)
        out[name] = {"cfg": tcfg, "np": np_params, "waves": waves,
                     "tokens": [r.generated for r in tout],
                     "logits": [np.stack(r.logits) for r in tout],
                     "ref_tokens": [r.generated for r in jout],
                     "ref_logits": [np.stack(r.logits) for r in jout],
                     "prefix_hits": teng.summary()["prefix_hits"]}
    g = out["granite"]
    tcache.reset()
    teng = tserve.ServeEngine(g["cfg"], params_from_numpy(g["np"], g["cfg"], device="cpu"),
                              device="cpu", **SPEC_KW)
    teng.warm()
    tout = ranks.serve_waves(teng, g["waves"])
    g["spec"] = {"tokens": [r.generated for r in tout],
                 "logits": [np.stack(r.logits) for r in tout]}
    return out


@pytest.fixture(scope="module")
def served(cases, tmp_path_factory):
    """Each mesh's ranks, one spawn each: the engine per arch; on 2 x 1
    also the one-row step, the one-shot per family, the refused batch and
    the packed gather."""
    work = str(tmp_path_factory.mktemp("ranks"))
    out = {}
    for mname, (d, m) in MESHES.items():
        jobs = [(f"engine:{n}", "engine_waves_run", (c["cfg"], c["np"], c["waves"], KW))
                for n, c in cases.items()]
        if mname == "d2":
            g = cases["granite"]
            jobs += [("one_row", "engine_waves_run",
                      (g["cfg"], g["np"], [g["waves"][0][:1]], KW)),
                     ("spec", "engine_waves_run", (g["cfg"], g["np"], g["waves"], SPEC_KW)),
                     ("refused", "oneshot_refused", (g["cfg"],)),
                     ("gather", "gather_rows_run", ())]
            jobs += [(f"oneshot:{n}", "oneshot_run", (_cfgs(a, ch)[0], ONESHOT_KW))
                     for n, (a, ch) in ONESHOT.items()]
        out[mname] = PM.run_ranks(ranks.suite, {"data": d, "model": m}, jobs, device="cpu",
                                  workdir=work, timeout=TIMEOUT)
    return out


def _worst(got: list, want: list) -> float:
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_on_a_data_mesh_matches_single_device(cases, served, arch, mesh):
    c = cases[arch]
    outs = [r[f"engine:{arch}"] for r in served[mesh]]
    r0 = outs[0]
    for other in outs[1:]:          # every rank serves the same
        assert other["tokens"] == r0["tokens"]
        assert _worst(other["logits"], r0["logits"]) == 0.0
    assert r0["tokens"] == c["tokens"] == c["ref_tokens"]
    assert _worst(r0["logits"], c["logits"]) < TOL
    assert _worst(r0["logits"], c["ref_logits"]) < TOL
    assert all(o["misses_after_warm"] == 0 for o in outs)
    s = r0["summary"]
    d, m = MESHES[mesh]
    assert (s["mesh"], s["n_devices"], s["backend"]) == ({"data": d, "model": m}, d * m, "gloo")
    assert s["requests_finished"] == 16 and s["prefix_hits"] == c["prefix_hits"] > 0
    # one gather over "data" a step, on top of the model axis's collectives
    assert s["collective_calls"]["all_gather"] >= s["prefill_steps"] + s["decode_steps"]
    # the steps ran at the local buckets: ceil(b / d) rows of the 8-row ones
    assert max(key[1] for key in r0["steps"]) == -(-KW["max_slots"] // d)


def test_a_one_row_step_on_two_data_ranks(cases, served):
    """One request alone: every step has one row, so data rank 1 computes
    only a pad row and still joins each gather."""
    c = cases["granite"]
    outs = [r["one_row"] for r in served["d2"]]
    assert outs[0]["tokens"] == outs[1]["tokens"] == [c["tokens"][0]]
    assert _worst(outs[0]["logits"], c["logits"][:1]) < TOL
    assert {key[1] for key in outs[0]["steps"]} == {1}
    assert all(o["misses_after_warm"] == 0 for o in outs)
    s = outs[1]["summary"]
    assert s["collective_calls"]["all_gather"] == s["prefill_steps"] + s["decode_steps"] > 1


def test_speculation_on_a_data_mesh_matches_single_device(cases, served):
    want = cases["granite"]["spec"]
    for r in served["d2"]:
        got = r["spec"]
        assert got["tokens"] == want["tokens"] == cases["granite"]["tokens"]
        assert _worst(got["logits"], want["logits"]) < TOL
        assert got["misses_after_warm"] == 0
        assert got["summary"]["accepted_tokens"] > 0 and got["summary"]["verify_steps"] > 0


@pytest.mark.parametrize("family", list(ONESHOT))
def test_oneshot_on_a_data_mesh_matches_single_device(served, family):
    arch, changes = ONESHOT[family]
    cfg = _cfgs(arch, changes)[0]
    tcache.reset()
    want = run_oneshot(cfg, device="cpu", **ONESHOT_KW)
    for r in served["d2"]:
        got = r[f"oneshot:{family}"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"].numpy())
        assert _worst(got["logits"], [lg.float().numpy() for lg in want["logits"]]) < TOL
        coll = got["mesh"]["collectives"]
        assert coll["decode"]["payload_bytes"] > 0
        # the model axis is 1: the data gathers are every collective
        assert set(got["mesh"]["collective_calls"]) == {"all_gather"}


def test_a_batch_that_does_not_split_over_the_data_axis_is_refused(served):
    assert all("does not split over 2 data ranks" in r["refused"] for r in served["d2"])


def test_gather_rows_packs_several_dtypes_in_one_message(served):
    for r in served["d2"]:
        got = r["gather"]
        assert got["i"][0] == "torch.int64"
        np.testing.assert_array_equal(got["i"][1], [0, 1, 2, 10, 11, 12])
        assert got["b"][0] == "torch.bfloat16" and got["b"][1].shape == (6, 2, 5)
        np.testing.assert_array_equal(got["b"][1][:, 0, 0], [0.5] * 3 + [1.5] * 3)
        np.testing.assert_array_equal(got["f"][1][:, 0], [-0.25] * 3 + [-1.25] * 3)


def test_local_buckets_round_up_over_the_data_axis():
    """A data rank contracts ceil(b / d) rows of a b-row serving bucket; a
    train step's batch must split evenly."""
    cfg = t_smoke("granite_3_2b")
    for b, local in ((1, 1), (3, 2), (8, 4)):
        got = twl.resolve_contractions(cfg, b, 1, kv_len=64, decode=True,
                                       mesh_shape={"data": 2, "model": 1}, local=True)
        want = twl.resolve_contractions(cfg, local, 1, kv_len=64, decode=True)
        assert [c.key_shape() for c in got] == [c.key_shape() for c in want]
    with pytest.raises(ValueError, match="does not split"):
        twl.resolve_contractions(cfg, 3, 8, train=True, mesh_shape={"data": 2}, local=True)


def test_launcher_serves_on_a_data_mesh():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--device", "cpu", "--batch", "4", "--prompt-len", "8", "--gen", "3",
         "--mesh", "2,1"],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: {'data': 2, 'model': 1} over 2 ranks, backend gloo" in out.stdout
    assert "collectives (gloo): {'all_gather': 3}" in out.stdout


def test_data_rows_pad_after_every_real_row():
    """A step's rows split contiguously in rank order, the padding last."""
    assert PM.data_rows(8) == (8, slice(0, 8))
    assert [PM.data_rows(5, 2, r) for r in (0, 1)] == [(3, slice(0, 3)), (3, slice(3, 6))]
    assert PM.data_rows(1, 2, 1) == (1, slice(1, 2))      # rank 1: only a pad row


def test_a_data_ranks_moe_plans_take_the_whole_batchs_capacity():
    """A serving data rank contracts its rows' dense shapes but the expert
    group at the whole bucket's capacity (its MoE routes as one device);
    a train step's rank routes its own tokens."""
    cfg = t_smoke("dbrx_132b")
    for b in (1, 3, 8):
        got = twl.resolve_contractions(cfg, b, 8, kv_len=64,
                                       mesh_shape={"data": 2, "model": 2}, local=True)
        moe = {(c.group, c.m) for c in got if c.kind == "grouped_moe"}
        assert moe == {(cfg.num_experts // 2, twl.layer_capacity(cfg, b * 8))}
    got = twl.resolve_contractions(cfg, 8, 8, train=True, mesh_shape={"data": 2}, local=True)
    fwd = {c.m for c in got if c.kind == "grouped_moe" and not c.role.endswith((".dA", ".dB"))}
    assert fwd == {twl.layer_capacity(cfg, 4 * 8)}
