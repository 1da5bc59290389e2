"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``).

The reference's meshes are ``jax.sharding.AbstractMesh``es (shape and axis
names, no devices), the port's plain ``{axis: size}`` dicts of the same
shape. On every leaf of every arch's smoke parameter tree, for the "tp"
table with and without fsdp and the "fsdp_only" one, on 1 x 2, 1 x 4 and
2 x 4 meshes, ``spec_for`` gives the reference's spec; ``layouts_for_mesh``
and ``activation_specs`` give the reference's. ``shard_act`` is the
identity. The port's placements differ from the table's where explicit
tensor parallelism cannot follow it: attention is placed by whole heads
(hymba's 25 heads stay whole on 2 ranks, where the reference's table
splits ``w_q``), and the SSD mixers stay whole.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.parallel import sharding as jsh
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as tsh

MESHES = [(1, 2), (1, 4), (2, 4)]
TABLES = [("tp", False), ("tp", True), ("fsdp_only", False)]


def _meshes(shape):
    d, m = shape
    return AbstractMesh((d, m), ("data", "model")), {"data": d, "model": m}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tuple(tree.shape)


@pytest.fixture(scope="module")
def smoke_trees():
    return {arch: TM.init_params(smoke_config(arch), 0, "cpu") for arch in ARCH_IDS}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_matches_reference_on_every_leaf(smoke_trees, arch, shape):
    jmesh, tmesh = _meshes(shape)
    n = 0
    for style, fsdp in TABLES:
        jr = jsh.make_rules(jmesh, fsdp=fsdp, style=style)
        tr = tsh.make_rules(tmesh, fsdp=fsdp, style=style)
        assert tr.batch == jr.batch and tr.axis_sizes == jr.axis_sizes
        assert [p for p, _ in tr.rules] == [p for p, _ in jr.rules]
        for path, leaf_shape in _leaves(smoke_trees[arch]):
            assert tr.spec_for(path, leaf_shape) == tuple(jr.spec_for(path, leaf_shape)), \
                (style, fsdp, path, leaf_shape)
            n += 1
    assert n > 0


@pytest.mark.parametrize("shape", [(1, 1), *MESHES])
@pytest.mark.parametrize("style", ["tp", "fsdp_only"])
def test_layouts_for_mesh_match_reference(shape, style):
    jmesh, tmesh = _meshes(shape)
    jd, jl = jsh.layouts_for_mesh(jmesh, style=style)
    td, tl = tsh.layouts_for_mesh(tmesh, style=style)
    assert td == jd
    assert [dataclasses.astuple(x) for x in tl] == [dataclasses.astuple(x) for x in jl]


def test_layouts_without_a_mesh_are_the_local_model():
    d, layouts = tsh.layouts_for_mesh(None)
    assert d == 1 and [x.name for x in layouts] == ["replicated"]


@pytest.mark.parametrize("seq_shard", [False, True])
def test_activation_specs_match_reference(seq_shard):
    jmesh, tmesh = _meshes((2, 4))
    want = jsh.activation_specs(jsh.make_rules(jmesh, seq_shard=seq_shard))
    got = tsh.activation_specs(tsh.make_rules(tmesh, seq_shard=seq_shard))
    assert got == {k: tuple(v) for k, v in want.items()}


def test_parallel_style_and_batch_axes_match_reference():
    assert tsh.BATCH == jsh.BATCH
    assert tsh.get_parallel_style() == jsh.get_parallel_style() == "tp"
    assert tsh.resolve_batch_axes() == jsh.resolve_batch_axes()
    tok = tsh.set_parallel_style("fsdp_only")
    try:
        assert tsh.resolve_batch_axes() == ("pod", "data", "model")
        d, layouts = tsh.layouts_for_mesh({"data": 2, "model": 4})
        assert d == 8 and [x.name for x in layouts] == ["gathered", "data"]
    finally:
        tsh._STYLE_CTX.reset(tok)
    with pytest.raises(ValueError):
        tsh.set_parallel_style("zero")


def test_shard_act_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert tsh.shard_act(x, tsh.BATCH, None, "model") is x


def test_attention_is_placed_by_whole_heads():
    """hymba at published widths: 25 heads, 5 KV heads of 64. The
    reference's table shards ``w_q`` (1,600 columns) on 2 ranks, splitting
    a head; the port holds the attention block whole there and shards its
    MLP. Where both head counts divide the axis (granite's 32 and 8 on 2 or
    8 ranks) attention shards; where only the q heads do (granite on 16),
    the q heads shard and K/V stay whole."""
    hymba = get_config("hymba_1_5b")
    assert (hymba.num_heads, hymba.num_kv_heads, hymba.resolved_head_dim) == (25, 5, 64)
    jr = jsh.make_rules(AbstractMesh((1, 2), ("data", "model")))
    assert tuple(jr.spec_for("layers/attn/w_q", (32, 1600, 1600))) == (None, None, "model")
    assert tsh.attention_split(25, 5, 2) == (1, 1)
    assert tsh.attention_split(32, 8, 2) == (2, 2) and tsh.attention_split(32, 8, 8) == (8, 8)
    assert tsh.attention_split(32, 8, 16) == (16, 1) and tsh.attention_split(32, 8, 1) == (1, 1)
    # a small tree with hymba's head structure (5 heads of 16): the same rule
    cfg = dataclasses.replace(smoke_config("hymba_1_5b"), num_heads=5, num_kv_heads=5,
                              head_dim=16)
    params = TM.init_params(cfg, 0, "cpu")
    mesh = {"data": 1, "model": 2}
    place = tsh.param_sharding(params, mesh, tsh.make_rules(mesh), cfg)
    assert all(v == () for v in place["layers"]["attn"].values())
    assert tsh.make_rules(mesh).spec_for("layers/attn/w_q", (2, 64, 80)) == \
        (None, None, "model")                       # the table alone would split
    assert place["layers"]["mlp"]["mlp_up"] == ((2, "model"),)
    assert place["layers"]["mlp"]["mlp_down"] == ((1, "model"),)
    assert all(v == () for v in place["layers"]["ssm"].values())   # the mixer, whole
    assert place["embed"] == ((0, "model"),)


class _Rank(types.SimpleNamespace):
    """One rank of a mesh, as ``shard_params`` reads it."""

    axis_names = ("data", "model")

    def local_rank(self, axis):
        return self.rank


@pytest.mark.parametrize("m", [2, 4])
def test_shard_params_slices_each_ranks_part(m):
    cfg = smoke_config("dbrx_132b")          # attention and 4 experts shard 2- and 4-way
    params = TM.init_params(cfg, 0, "cpu")
    parts = [tsh.shard_params(params, cfg, _Rank(shape={"data": 1, "model": m}, rank=r))
             for r in range(m)]
    L = params["layers"]
    for got, name, dim in ((lambda p: p["embed"], "embed", 0),
                           (lambda p: p["layers"]["attn"]["w_q"], "w_q", 2),
                           (lambda p: p["layers"]["attn"]["w_o"], "w_o", 1),
                           (lambda p: p["layers"]["moe"]["router"], "router", 2),
                           (lambda p: p["layers"]["moe"]["moe_down"], "moe_down", 1)):
        full = got(params)
        shards = [got(p) for p in parts]
        assert all(s.shape[dim] == full.shape[dim] // m and s.is_contiguous() for s in shards)
        torch.testing.assert_close(torch.cat(shards, dim=dim), full, rtol=0, atol=0)
    # whole on every rank: the norms
    for p in parts:
        assert p["layers"]["ln1"].shape == L["ln1"].shape
        torch.testing.assert_close(p["final_norm"], params["final_norm"], rtol=0, atol=0)


def test_shard_params_refuses_data_parallel_placements():
    """ZeRO-3 placements over "data" (``fsdp``) and over ("data", "model")
    (``fsdp_only``) shard now (they raised before multi-device training):
    on a 2 x 2 mesh every rank's shard of every leaf has the shape the
    reference's ``spec_for`` gives it, and the ranks' shards of ``w_q`` put
    together are the leaf. What ``shard_params`` still refuses is a leaf
    that is not a tensor."""
    cfg = smoke_config("granite_3_2b")
    params = TM.init_params(cfg, 0, "cpu")
    jmesh, tmesh = _meshes((2, 2))
    for style, fsdp in (("tp", True), ("fsdp_only", False)):
        jr = jsh.make_rules(jmesh, fsdp=fsdp, style=style)
        parts = [tsh.shard_params(params, cfg, _Rank2(tmesh, r),
                                  tsh.make_rules(tmesh, fsdp=fsdp, style=style))
                 for r in range(4)]
        for path, shape in _leaves(params):
            spec = tuple(jr.spec_for(path, shape))
            want = tuple(n // (4 if isinstance(a, tuple) else 2 if a else 1)
                         for n, a in zip(shape, spec + (None,) * len(shape)))
            for part in parts:
                got = part
                for k in path.split("/"):
                    got = got[k]
                assert tuple(got.shape) == want, (style, path, spec)
        w_q = [p["layers"]["attn"]["w_q"] for p in parts]
        if style == "tp":       # K over data, N over model
            whole = torch.cat([torch.cat(w_q[d * 2:d * 2 + 2], dim=2) for d in range(2)], dim=1)
        else:                   # K over data x model
            whole = torch.cat(w_q, dim=1)
        torch.testing.assert_close(whole, params["layers"]["attn"]["w_q"], rtol=0, atol=0)
    with pytest.raises(TypeError, match="before precombining"):
        tsh.shard_params({"w": np.zeros((2, 2))}, cfg, _Rank2(tmesh, 0))


class _Rank2:
    """Rank ``r`` of a (data, model) mesh, row-major, as ``shard_params``
    reads it: its index along one axis or a tuple of them."""

    axis_names = ("data", "model")

    def __init__(self, shape, r):
        self.shape, self.idx = shape, {"data": r // shape["model"], "model": r % shape["model"]}

    def local_rank(self, axis):
        idx = 0
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            idx = idx * self.shape[a] + self.idx[a]
        return idx