"""Checkpointing: atomic, async, integrity-checked, in the reference's format.

Layout:  <dir>/step_<N>/manifest.json + arrays.npz
  * writes go to ``step_<N>.tmp`` then ``os.replace``, so a crash mid-save
    never corrupts the latest checkpoint (atomic-rename protocol);
  * the manifest stores the flattened tree's keys, shapes, dtypes and a
    sha256 of the array payload, so bit-rot or truncation is detected at
    load;
  * arrays are stored whole; ``restore_checkpoint`` places them on the
    ``device`` the caller names, or, given a ``mesh`` and its ``rules``,
    narrows each to this rank's placement on the mesh's device: the
    elastic path (the mesh a run saved on is irrelevant);
  * ``CheckpointManager`` adds async save (the host copy is made at once,
    the disk write on a background thread), retention and ``wait``. On a
    mesh the ranks gather each sharded leaf whole (``gather_state``), rank
    0 writes, and every rank waits on a barrier in ``wait``.

The keys, their order and the payload's bytes are the reference package's
(``src/repro/checkpoint``): a dict is flattened in sorted key order, a list
or tuple by index, the path joined with ``/`` (``layers/attn/w_q``), and
each array stored in the npz under its key with ``/`` as ``__``. bfloat16
leaves are stored as uint16 views (npz has no bf16). So each package loads
the other's checkpoints, and the same tree saves to the same digest.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager",
           "gather_state"]

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = ""):
    """(keys, leaves) in the reference's flatten order; None is no leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    keys, leaves = [], []
    for k, v in items:
        ks, ls = _flatten(v, f"{prefix}/{k}" if prefix else k)
        keys += ks
        leaves += ls
    return keys, leaves


def _unflatten(like, it):
    """Rebuild ``like``'s structure, its leaves taken in order from ``it``."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return next(it)


def _to_np(x):
    """A leaf as a C-ordered host array and its dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        x = t.numpy()
    x = np.ascontiguousarray(x)
    return x, str(x.dtype)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomic whole-array checkpoint of a nested dict/list of tensors (or
    numpy arrays). Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    keys, leaves = _flatten(tree)
    arrays, dtypes = {}, {}
    for k, leaf in zip(keys, leaves):
        arrays[k], dtypes[k] = _to_np(leaf)
    buf = io.BytesIO()
    np.savez(buf, **{k.replace("/", "__"): v for k, v in arrays.items()})
    payload = buf.getvalue()
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(payload)
    manifest = {
        "step": step,
        "keys": keys,
        "dtypes": dtypes,
        "shapes": {k: list(np.shape(a)) for k, a in arrays.items()},
        "sha256": hashlib.sha256(payload).hexdigest(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        # replaying after a restore overwrites the stale later checkpoint;
        # latest_step() ignores manifest-less dirs, so a crash inside this
        # window loses only this step, never an older checkpoint
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def gather_state(tree, placement, mesh):
    """``tree`` (this rank's shards, ``placement`` mirroring it) with every
    sharded leaf all-gathered whole over each axis it is split over, leaf
    by leaf, as host tensors: what a whole-array save writes. Every rank of
    the mesh must call it, in the same order."""
    from repro_torch.parallel.collectives import all_gather

    def whole(t, where):
        if isinstance(t, dict):
            return {k: whole(v, where[k]) for k, v in t.items()}
        if t is None:
            return None
        with torch.no_grad():
            for dim, axis in where:
                if mesh.size(axis) > 1:
                    t = all_gather(t, mesh, axis, dim=dim)
        return _to_host(t)

    return whole(tree, placement)


def restore_checkpoint(directory: str, tree_like, step: int | None = None,
                       device="cuda", verify: bool = True, mesh=None, rules=None, cfg=None):
    """Restore into the structure of ``tree_like`` (its leaves only name the
    keys: tensors, arrays, anything), as tensors on ``device`` ("cuda"
    unless the caller asks for the CPU; without a card that raises). The
    latest step unless ``step`` is given. Returns (tree, step, extra).

    With a ``mesh`` (``parallel.mesh.Mesh``) each whole array is narrowed
    to this rank's part under ``rules`` (``parallel.sharding.make_rules``
    of that mesh; ``cfg`` gives the head counts its placement reads) and
    placed on the mesh's device: a run saved on any mesh, or on one device,
    resumes on this one."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("restore_checkpoint: no CUDA device (pass device='cpu' to "
                           "restore onto the host)")
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        payload = f.read()
    if verify and hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    npz = np.load(io.BytesIO(payload))

    keys, _ = _flatten(tree_like)
    if keys != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(keys)
        raise ValueError(f"checkpoint/model structure mismatch: {sorted(missing)[:8]}")
    out = []
    for k in keys:
        arr = npz[k.replace("/", "__")]
        if manifest["dtypes"][k] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t if mesh is not None else t.to(device))
    tree = _unflatten(tree_like, iter(out))
    if mesh is not None:
        from repro_torch.parallel.sharding import make_rules, param_sharding, shard_leaf
        from repro_torch.tree import tree_map
        placement = param_sharding(tree, mesh, rules or make_rules(mesh), cfg)
        tree = tree_map(lambda t, where: shard_leaf(t, where, mesh).to(mesh.device,
                                                                        copy=True),
                        tree, placement)
    return tree, step, manifest.get("extra", {})


class CheckpointManager:
    """Async save + retention + preemption-safe flush."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True, mesh=None,
                 placement=None):
        """``mesh`` and ``placement`` (mirroring the saved tree): each save
        gathers the shards whole, rank 0 writes, and ``wait`` is a barrier
        of every rank."""
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self.placement = placement
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()  # one in-flight save at a time
        # the host copy now, so the caller may update the tree in place
        if self.mesh is not None:
            host = gather_state(tree, self.placement, self.mesh)
            if self.mesh.rank != 0:
                return
        else:
            _, leaves = _flatten(tree)
            host = _unflatten(tree, iter([_to_host(x) for x in leaves]))

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra)
                self._gc()
            except Exception as e:  # pragma: no cover
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                raise self._error

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        if self._error:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like, device="cuda", rules=None, cfg=None):
        return restore_checkpoint(self.directory, tree_like, device=device, mesh=self.mesh,
                                  rules=rules, cfg=cfg)

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", name))
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)


def _to_host(x):
    """A copy of a leaf on the host (a tensor stays a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)
