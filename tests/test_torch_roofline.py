"""The roofline and the dry run on the meta device.

* ``roofline.analytic.analytic_costs`` is the reference's model: for every
  arch x ``SHAPE_CELLS`` cell x {single, multi} mesh it gives the
  reference's FLOPs, HBM bytes, collective bytes and detail (relative
  ``RTOL`` = 1e-12), and ``terms`` prices them with the H100's profile.
* One dry-run cell per family's representative (granite ``train_4k``, dbrx
  ``decode_32k``, mamba2 ``prefill_32k``, hymba ``long_500k``, musicgen and
  pixtral ``decode_32k``, and kimi_k2_1t ``decode_32k`` on the 512-rank
  mesh), each as rank 0 of a fake process group on ``meta``: ``status: ok``,
  ``n_params`` equal to the count of the reference's ``jax.eval_shape``
  init, and the rank's argument bytes equal to the rule table's shard sizes
  (parameters, AdamW state, inputs), with positive traced FLOPs and
  collective bytes.
* A meta tensor through each of the seven kernel wrappers takes the plain
  version (exact in shape, no launch counted); a tensor on a CUDA device
  never does.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs.base import SHAPE_CELLS as J_CELLS
from repro.models import model as JM
from repro.roofline.analytic import analytic_costs as j_costs
from repro_torch import kernels
from repro_torch.configs import SHAPE_CELLS, get_config, list_archs
from repro_torch.core import algorithms as alg, hardware, plan_cache
from repro_torch.kernels import ref
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.roofline.analytic import analytic_costs
from repro_torch.tree import tree_leaves, tree_map

RTOL = 1e-12
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _close(a, b):
    return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0) or a == b


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_costs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get(arch)
    n = 1_000_003 * (1 + len(arch))
    for cell_name, cell in SHAPE_CELLS.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(J_CELLS[cell_name])
        for mesh in MESHES.values():
            got = analytic_costs(cfg, cell, mesh, n, n // 2)
            want = j_costs(jcfg, J_CELLS[cell_name], mesh, n, n // 2)
            for f in ("flops", "hbm_bytes", "coll_bytes"):
                assert _close(getattr(got, f), getattr(want, f)), (cell_name, f)
            for k, v in want.detail.items():
                assert got.detail[k] == v or _close(got.detail[k], v), (cell_name, k)
            h = hardware.H100_SXM
            assert got.terms(h) == (got.flops / 989e12, got.hbm_bytes / 3.35e12,
                                    got.coll_bytes / 450e9)


CELLS = {"granite": ("granite_3_2b", "train_4k", "single"),
         "dbrx": ("dbrx_132b", "decode_32k", "single"),
         "mamba2": ("mamba2_370m", "prefill_32k", "single"),
         "hymba": ("hymba_1_5b", "long_500k", "single"),
         "musicgen": ("musicgen_large", "decode_32k", "single"),
         "pixtral": ("pixtral_12b", "decode_32k", "single"),
         "kimi": ("kimi_k2_1t", "decode_32k", "multi")}


@pytest.fixture(scope="module")
def records():
    out = {name: dryrun.run_cell(*cell, None) for name, cell in CELLS.items()}
    plan_cache.reset()
    return out


def _reference_n_params(arch):
    shapes = jax.eval_shape(lambda: JM.init_params(j_get(arch), jax.random.PRNGKey(0)))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def _shard_bytes(tree, placement, sizes, itemsize=None):
    """Each leaf's bytes over the ranks of the axes its placement names."""
    def one(t, where):
        n = math.prod(math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
                      for _, ax in where)
        return t.numel() * (itemsize or t.element_size()) // n
    return sum(tree_leaves(tree_map(one, tree, placement)))


@pytest.mark.parametrize("name", list(CELLS))
def test_dry_run_cell(records, name):
    arch, shape, mesh = CELLS[name]
    rec = records[name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_params"] == _reference_n_params(arch)
    assert 0 < rec["n_active_params"] <= rec["n_params"]
    cfg, cell = get_config(arch), SHAPE_CELLS[shape]
    sizes = {"data": 32 if mesh == "multi" else 16, "model": 16}
    full = M.init_params(cfg, 0, device="meta")

    class _Mesh:                    # the rule table reads the axis sizes only
        shape = sizes
        axis_names = ("data", "model")

    placement = SH.param_sharding(full, _Mesh, SH.make_rules(_Mesh, fsdp=cfg.fsdp), cfg)
    by = rec["argument_bytes_by"]
    assert by["params"] == _shard_bytes(full, placement, sizes)
    # m and v in float32 per shard, and the int32 step counter
    opt = 2 * _shard_bytes(full, placement, sizes, itemsize=4) + 4 if cell.kind == "train" \
        else 0
    assert by["opt"] == opt
    b = cell.global_batch // sizes["data"] if cell.global_batch % sizes["data"] == 0 \
        else cell.global_batch
    cb = cfg.num_codebooks if cfg.frontend == "audio_codebooks" else 1
    if cell.kind == "train":
        want = 2 * 8 * b * cell.seq_len * cb
    elif cell.kind == "prefill":
        want = 8 * b * cell.seq_len * cb
    else:
        cache = tree_bytes_meta(cfg, b, cell.seq_len, sizes["model"])
        want = cache + 8 * b * cb
    assert by["inputs"] == want
    assert rec["argument_bytes"] == sum(by.values())
    assert rec["traced_flops"] > 0 and rec["traced_bytes"] > 0
    assert rec["collective_bytes"] > 0 and rec["collective_calls"]
    assert rec["roofline"]["chips"] == (512 if mesh == "multi" else 256)
    a = rec["analytic"]
    assert a["flops_dev"] > 0 and a["bottleneck"] in ("compute", "memory", "collective")


def tree_bytes_meta(cfg, b, S, model):
    """The decode cache's bytes on a rank: K/V of the rank's KV heads (whole
    where the KV heads do not split over the model axis), the SSD state."""
    kv = cfg.num_kv_heads // SH.attention_split(cfg.num_heads, cfg.num_kv_heads, model)[1]
    isz = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    if cfg.family != "ssm":
        total += 2 * cfg.num_layers * b * S * kv * cfg.resolved_head_dim * isz
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.num_layers * b * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * isz
    return total


def test_granite_train_4k_traces_near_its_analytic_flops():
    """granite ``train_4k`` on 16 x 16 cut to 2 layers: its 8 KV heads do
    not split 16 ways, so each rank takes 2 of the 32 q heads with whole
    K/V (``sharding.attention_split``) and traces at most 2x the analytic
    FLOPs of the same depth (with attention whole on every rank, replayed
    by remat, it traced ~7x at published depth). ``remat_policy="dots"``
    runs, and its recompute skips the 2-D products: fewer FLOPs than
    ``full``, within 2x of its own analytic figure (fwd x 3.15)."""
    recs = {pol: dryrun.run_cell("granite_3_2b", "train_4k", "single", None, layers=2,
                                 remat_policy=pol) for pol in ("full", "dots")}
    plan_cache.reset()
    for pol, rec in recs.items():
        assert rec["status"] == "ok", rec.get("error")
        assert rec["num_layers"] == 2 and rec["remat_policy"] == pol
        ratio = rec["traced_flops"] / rec["analytic"]["flops_dev"]
        assert 1.0 < ratio <= 2.0, (pol, ratio)
    assert recs["dots"]["traced_flops"] < recs["full"]["traced_flops"]
    assert recs["dots"]["collective_bytes"] == recs["full"]["collective_bytes"]


def test_the_dry_run_leaves_no_process_group(records):
    assert not torch.distributed.is_initialized()
    assert dryrun.run_cell("granite_3_2b", "long_500k", "single", None)["status"] == "skipped"


# ---------------------------------------------------------------------------
# the wrappers on meta and on a CUDA device
# ---------------------------------------------------------------------------

S = alg.strassen()
BY = 32


def _calls(dev):
    """Each wrapper's call on tensors of ``dev`` (fresh each time)."""
    def t(*shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "group_combine": lambda: kernels.group_combine(t(64, 128), S.U),
        "batched_group_combine": lambda: kernels.batched_group_combine(t(3, 64, 128), S.U),
        "fused_gemm_combine_h": lambda: kernels.fused_gemm_combine_h(
            t(7, 32, 64), t(7, 64, 16), S.W),
        "batched_fused_gemm_combine_h": lambda: kernels.batched_fused_gemm_combine_h(
            t(3, 7, 32, 64), t(7, 64, 16), S.W),
        "tiled_matmul": lambda: kernels.tiled_matmul(t(33, 40), t(40, 24)),
        "group_combine_quant": lambda: kernels.group_combine_quant(t(64, 128), S.U, BY),
        "fused_gemm_combine_h_quant": lambda: kernels.fused_gemm_combine_h_quant(
            t(7, 32, 64, dtype=torch.int8), t(7, 32, 64 // BY),
            t(7, 64, 16, dtype=torch.int8), t(7, 64 // BY, 16), S.W),
    }


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_a_meta_tensor_takes_the_plain_version(name):
    kernels.reset_launch_counts()
    got = _calls("meta")[name]()
    want = _calls("cpu")[name]()
    assert all(o.is_meta for o in (got if isinstance(got, tuple) else (got,)))
    assert _shapes(got) == _shapes(want)
    assert sum(kernels.launch_counts().values()) == 0


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: this host has no card, and
    the wrappers choose their path by the device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_a_cuda_tensor_never_takes_the_plain_version(name, monkeypatch):
    plain = []
    for f in ("group_combine_ref", "fused_gemm_combine_h_ref", "tiled_matmul_ref",
              "group_combine_quant_ref", "fused_gemm_combine_h_quant_ref"):
        monkeypatch.setattr(ref, f, lambda *a, f=f, **k: plain.append(f))
    calls = _calls("meta")
    real = torch.ones

    def on_card(*shape, dtype=torch.float32, device=None):
        return torch.Tensor._make_subclass(_OnCard, real(*shape, dtype=dtype, device="meta"))

    monkeypatch.setattr(torch, "ones", on_card)
    with pytest.raises(Exception) as err:    # the kernel path: it launches or raises
        calls[name]()
    assert plain == []
    if not torch.cuda.is_available():       # it got as far as initializing CUDA
        assert "CUDA" in str(err.value)
