"""The port's checkpoints (``repro_torch.checkpoint``) against the reference's.

The reference's own cases (``tests/test_checkpoint.py``: bf16 round trip,
retention, corruption, structure mismatch, a crash mid-save, async save),
on torch tensors; resharding on restore waits for the multi-device work.
Then the format: the same tree saved by each package gives the same keys,
the same manifest and the same sha256 of the same payload bytes, and each
package restores the other's checkpoint exactly (bf16 included), down to a
model's whole parameter tree.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((8, 4), generator=g),
        "nested": {"b": torch.ones((3,), dtype=torch.bfloat16),
                   "c": torch.arange(5, dtype=torch.int32)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_roundtrip_with_bf16(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"note": "x"})
    got, step, extra = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 7 and extra["note"] == "x"
    assert list(got) == list(t) and list(got["nested"]) == list(t["nested"])
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_0000000003", "step_0000000004"]


def test_integrity_detects_corruption(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    path = tmp_path / "step_0000000001" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        restore_checkpoint(str(tmp_path), _tree(), device="cpu")


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    other = {"a": torch.zeros((8, 4)),
             "nested": {"b": torch.zeros((3,), dtype=torch.bfloat16),
                        "WRONG": torch.zeros((5,), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), other, device="cpu")


def test_crash_mid_save_never_corrupts_latest(tmp_path):
    """A stale .tmp dir (a simulated crash) is invisible to latest_step."""
    save_checkpoint(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_0000000009.tmp")
    (tmp_path / "step_0000000009.tmp" / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 5
    _, step, _ = restore_checkpoint(str(tmp_path), _tree(), device="cpu")
    assert step == 5


def test_async_save_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    mgr.save(1, t)
    t["a"].zero_()                  # the manager copied the tree at save()
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    got, _, _ = mgr.restore_latest(_tree(), device="cpu")
    assert torch.equal(got["a"], _tree()["a"])


# ---------------------------------------------------------------------------
# The format, against the reference's
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    """One tree of numpy arrays (f32, bf16 as uint16 bits, int32, a list)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((6, 4)).astype(np.float32),
        "layers": {"attn": {"w_q": rng.standard_normal((2, 4, 4)).astype(np.float32)},
                   "ln1": rng.standard_normal((2, 4)).astype(np.float32)},
        "bf": rng.standard_normal((5,)).astype(np.float32),
        "ids": np.arange(7, dtype=np.int32),
        "stack": [np.ones((2,), np.float32), np.zeros((3,), np.float32)],
    }


def _as_jax(t):
    return jax.tree.map(jnp.asarray, dict(t, bf=jnp.asarray(t["bf"], jnp.bfloat16)))


def _as_torch(t):
    conv = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in t.items()}
    conv["layers"] = {"attn": {"w_q": torch.from_numpy(t["layers"]["attn"]["w_q"])},
                      "ln1": torch.from_numpy(t["layers"]["ln1"])}
    conv["bf"] = torch.from_numpy(t["bf"]).to(torch.bfloat16)
    conv["stack"] = [torch.from_numpy(a) for a in t["stack"]]
    return conv


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_same_tree_gives_the_reference_keys_and_digest(tmp_path):
    t = _np_tree()
    pj = j_save(str(tmp_path / "ref"), 3, _as_jax(t), extra={"k": 1})
    pt = save_checkpoint(str(tmp_path / "port"), 3, _as_torch(t), extra={"k": 1})
    mj, mt = _manifest(pj), _manifest(pt)
    assert mt == mj
    assert mt["keys"] == ["bf", "ids", "layers/attn/w_q", "layers/ln1", "stack/0",
                          "stack/1", "w"]
    assert mt["dtypes"]["bf"] == "bfloat16"
    with open(os.path.join(pj, "arrays.npz"), "rb") as a, \
            open(os.path.join(pt, "arrays.npz"), "rb") as b:
        assert a.read() == b.read()


def test_port_restores_reference_checkpoint(tmp_path):
    t = _np_tree(1)
    j_save(str(tmp_path), 4, _as_jax(t))
    got, step, _ = restore_checkpoint(str(tmp_path), _as_torch(_np_tree(2)), device="cpu")
    want = _as_torch(t)
    assert step == 4
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"], want["bf"])
    assert torch.equal(got["layers"]["attn"]["w_q"], want["layers"]["attn"]["w_q"])
    assert isinstance(got["stack"], list) and torch.equal(got["stack"][1], want["stack"][1])
    assert got["ids"].dtype == torch.int32 and torch.equal(got["ids"], want["ids"])


def test_reference_restores_port_checkpoint(tmp_path):
    t = _np_tree(3)
    save_checkpoint(str(tmp_path), 9, _as_torch(t))
    got, step, _ = j_restore(str(tmp_path), _as_jax(_np_tree(4)))
    want = _as_jax(t)
    assert step == 9
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ["musicgen_large", "mamba2_370m"])
def test_model_params_cross_load(arch, tmp_path):
    """A bf16 model tree (musicgen's codebook stacks; mamba2's f32 SSD leaves
    beside bf16 ones) saved by the reference restores in the port equal to
    the same weights converted directly, and saves back to the same digest."""
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    pj = j_save(str(tmp_path / "ref"), 1, jp)
    like = TM.init_params(tcfg, 0, device="cpu")
    got, _, _ = restore_checkpoint(str(tmp_path / "ref"), like, device="cpu")
    want = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
                             device="cpu")
    for a, b in zip(_leaves(want), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pt = save_checkpoint(str(tmp_path / "port"), 1, got)
    assert _manifest(pt) == _manifest(pj)
