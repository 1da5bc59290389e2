"""``("data", "model")`` device meshes over ``torch.distributed``, the
ambient mesh, and a way to start one process per rank.

The counterpart of the reference's ``launch/mesh.py`` (``make_local_mesh``)
and of its ambient ``jax.sharding`` mesh. The port runs SPMD with explicit
collectives: each rank is its own process, :func:`init_mesh` joins it to the
process group and builds a ``DeviceMesh`` over ``init_device_mesh``, and
:func:`use_mesh` makes a mesh the ambient one that the model code, the
sharded decision tier (``falcon_gemm.plan_sharded``,
``sharding.layouts_for_mesh``) and the serving engines read.

The backend is chosen explicitly (:func:`choose_backend`): ``nccl`` where
each rank has a card of its own, ``gloo`` where ranks share one card or run
on the CPU. A gloo mesh's collectives on CUDA tensors cross through pinned
host buffers (``collectives``); on one shared card such a mesh checks the
multi-process path and says nothing about a link's rate. Nothing falls
back: a mesh the backend cannot place, a rank that cannot start or a
collective that fails raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import math
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

from repro_torch.core.workloads import _mesh_factors

from .collectives import CollectiveStats

__all__ = ["AXES", "Mesh", "mesh_factors", "data_rows", "choose_backend", "init_mesh", "world_mesh",
           "mesh_for", "use_mesh", "current_mesh", "shutdown", "run_ranks",
           "make_local_mesh", "make_production_mesh", "production_mesh_shape"]

AXES = ("data", "model")


def mesh_factors(mesh_shape) -> tuple[int, int]:
    """(data, model) of a ``{"data": d, "model": m}`` dict (a missing axis
    is 1; a ``"pod"`` axis multiplies data) or a (data, model) tuple; None
    or empty => (1, 1). The workload registry's reading (the reference's);
    an axis the mesh does not have raises."""
    if isinstance(mesh_shape, dict) and set(mesh_shape) - {"pod", *AXES}:
        raise ValueError(f"mesh_shape {mesh_shape}: unknown axes "
                         f"{sorted(set(mesh_shape) - {'pod', *AXES})}")
    return _mesh_factors(mesh_shape)


def data_rows(batch: int, data: int = 1, rank: int = 0) -> tuple[int, slice]:
    """How a ``batch``-row step splits over ``data`` ranks: the rows each
    rank computes, ``ceil(batch / data)`` (its local bucket), and data rank
    ``rank``'s contiguous slice of the batch padded to ``data`` times that,
    the padding after every real row. The one policy of the serving engine,
    ``run_oneshot`` and the workload registry's local shapes."""
    lb = -(-batch // data)
    return lb, slice(rank * lb, (rank + 1) * lb)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a ``("data", "model")`` mesh: its shape, the
    process group's backend, this rank's device and global rank, the
    ``DeviceMesh`` whose per-axis groups the collectives run on, and the
    collectives' counters (``stats``)."""

    shape: dict
    backend: str
    device: torch.device
    rank: int
    device_mesh: object
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    axis_names = AXES

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())

    @property
    def staged(self) -> bool:
        """Whether collectives on this rank's tensors cross host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def size(self, axis="model") -> int:
        """Ranks along ``axis``: one axis name, or a tuple of them (their
        product)."""
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    def local_rank(self, axis="model") -> int:
        """This rank's index along ``axis``; along a tuple of axes, the
        row-major index over them (``("data", "model")``: the global rank)."""
        if isinstance(axis, tuple):
            idx = 0
            for a in axis:
                idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
            return idx
        return self.device_mesh.get_local_rank(axis)

    def data_rows(self, batch: int) -> tuple[int, slice]:
        """This rank's local bucket and row slice of a ``batch``-row step
        (:func:`data_rows` over the data axis)."""
        return data_rows(batch, self.size("data"), self.local_rank("data"))

    def group(self, axis="model"):
        """The process group of ``axis``; of a tuple of axes, the group of
        the sub-mesh they span (both axes: the whole world)."""
        if isinstance(axis, tuple):
            axes = tuple(a for a in axis if self.shape.get(a, 1) > 1) or axis[:1]
            if len(axes) == 1:
                return self.device_mesh.get_group(axes[0])
            if axes != AXES:
                raise ValueError(f"group: axes {axis}; a joint group spans "
                                 f"{AXES} in that order")
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def summary(self) -> dict:
        """The mesh, its backend and the collectives' counters, as the
        engines' ``summary()``/``stats()`` report them."""
        return {"mesh": dict(self.shape), "n_devices": self.n_devices,
                "backend": self.backend, "device": str(self.device),
                "staged": self.staged, **self.stats.as_dict()}


_WORLD: Mesh | None = None
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def choose_backend(device, world: int) -> str:
    """``nccl`` when every one of ``world`` ranks can have a card of its own,
    ``gloo`` when they share cards or run on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def init_mesh(mesh_shape, backend: str | None = None, init_method: str = "env://", *,
              rank: int | None = None, world_size: int | None = None, device="cuda",
              timeout_s: float = 300.0) -> Mesh:
    """Join this process to the process group as ``rank`` of ``world_size``
    (default: the ``RANK`` and ``WORLD_SIZE`` of the environment, as
    ``torchrun`` sets them) and build its mesh.

    ``backend`` defaults to :func:`choose_backend`. ``nccl`` needs CUDA and
    a card per rank; ``gloo`` takes CUDA tensors (staged through pinned host
    memory) or CPU ones. On CUDA a rank takes card ``rank % cards``, so the
    ranks of a gloo mesh on one card share it. A collective that waits
    longer than ``timeout_s`` raises. The mesh becomes this process's
    :func:`world_mesh`; :func:`shutdown` leaves the group."""
    global _WORLD
    d, m = mesh_factors(mesh_shape)
    world = d * m
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_mesh: no CUDA device (pass device='cpu' for a gloo mesh of "
                           "CPU ranks)")
    backend = backend or choose_backend(device, world)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_mesh: backend {backend!r}; the port runs 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("init_mesh: nccl runs on CUDA tensors; use gloo on the CPU")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"init_mesh: nccl needs a card per rank: {world} ranks, "
                               f"{torch.cuda.device_count()} card(s) visible (ranks that "
                               "share a card run over gloo)")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if world_size != world:
        raise ValueError(f"init_mesh: mesh {d} x {m} needs {world} ranks, the group has "
                         f"{world_size}")
    if dist.is_initialized():
        raise RuntimeError("init_mesh: this process already belongs to a process group")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", (d, m),
                          mesh_dim_names=AXES)
    _WORLD = Mesh({"data": d, "model": m}, backend, device, rank, dm)
    return _WORLD


def make_local_mesh(backend: str | None = None, init_method: str = "env://",
                    device="cuda") -> Mesh:
    """Every rank of the process group as a (data, model=1) mesh: the
    reference's ``make_local_mesh`` (whatever devices exist). The world
    size is ``WORLD_SIZE``'s."""
    n = int(os.environ["WORLD_SIZE"])
    return init_mesh({"data": n, "model": 1}, backend, init_method, device=device)


def production_mesh_shape(world: int, multi_pod: bool = False) -> dict:
    """The reference's production mesh as a (data, model) shape: 16 x 16 =
    256 ranks a pod; with ``multi_pod`` two pods, 512 ranks (the pod axis
    folds into "data", as the workload registry reads it). A world of
    another size raises and names the rank count the mesh needs."""
    need = 512 if multi_pod else 256
    if int(world) != need:
        raise ValueError(f"the production mesh ({'2 x ' if multi_pod else ''}16 x 16) needs "
                         f"{need} ranks; this process group has {world}")
    return {"data": 32 if multi_pod else 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, backend: str | None = None,
                         init_method: str = "env://", device="cuda") -> Mesh:
    """Join the process group (``WORLD_SIZE`` ranks) as the reference's
    production mesh (:func:`production_mesh_shape`)."""
    shape = production_mesh_shape(int(os.environ["WORLD_SIZE"]), multi_pod)
    return init_mesh(shape, backend, init_method, device=device)


def world_mesh() -> Mesh | None:
    """The mesh :func:`init_mesh` built in this process, if any."""
    return _WORLD


def mesh_for(mesh_shape) -> Mesh | None:
    """The mesh serving ``mesh_shape`` runs on: None for one device, else
    this process's :func:`world_mesh`, which must have that shape. Asking
    for a mesh never ends in single-device serving: a process outside a mesh
    raises."""
    d, m = mesh_factors(mesh_shape)
    if d * m <= 1:
        return None
    if _WORLD is None:
        raise RuntimeError(
            f"mesh_shape {mesh_shape} spans {d * m} ranks, but this process belongs to no "
            "mesh: start the ranks through `python -m repro_torch.launch.serve --mesh "
            "DATA,MODEL` (or torchrun) or call parallel.mesh.init_mesh in each")
    if (_WORLD.shape["data"], _WORLD.shape["model"]) != (d, m):
        raise ValueError(f"mesh_shape {mesh_shape}: this rank's mesh is {_WORLD.shape}")
    return _WORLD


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the ambient mesh inside the block (None: no mesh)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Mesh | None:
    """The ambient mesh (:func:`use_mesh`), or None."""
    return _AMBIENT.get()


def shutdown() -> None:
    """Leave the process group (if joined) and forget the world mesh."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def _rank_main(fn, rank: int, world: int, shape: tuple[int, int], backend, init_method,
               device, out_dir: str, args) -> None:
    """One spawned rank: join the mesh, run ``fn(mesh, *args)`` under it,
    save what it returns (or the traceback of what it raised). A rank on
    the CPU takes one intra-op thread: the ranks share the host's cores."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        mesh = init_mesh(shape, backend, init_method, rank=rank, world_size=world,
                         device=device)
        with use_mesh(mesh):
            out = fn(mesh, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown()


def run_ranks(fn, mesh_shape, *args, backend: str | None = None, device="cuda",
              workdir: str | None = None, timeout: float | None = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``mesh_shape`` mesh, each
    a spawned process joined through a file store under ``workdir`` (a
    fresh directory, removed after), and return each rank's result, rank
    order. ``fn`` and ``args`` are pickled (``fn`` by its import path),
    results too. A rank that fails, or a run past ``timeout`` seconds (None:
    no limit), stops every rank and raises with the failing rank's
    traceback."""
    d, m = mesh_factors(mesh_shape)
    world = d * m
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    init_method = "file://" + os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, (d, m), backend, init_method, str(device),
                               out_dir, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            running = [p for p in procs if p.exitcode is None]
            left = None if deadline is None else deadline - time.monotonic()
            if not running or (left is not None and left <= 0) or \
                    any(p.exitcode not in (None, 0) for p in procs):
                break
            wait([p.sentinel for p in running], timeout=left)
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            errs = [open(os.path.join(out_dir, f"rank{r}.err")).read()
                    for r in failed if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
            why = "timed out" if all(c is None for c in failed.values()) else "failed"
            raise RuntimeError(f"run_ranks: {why}, exit codes {failed}"
                               + ("".join("\n" + e for e in errs[:1])))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
