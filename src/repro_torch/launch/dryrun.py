"""Production-mesh dry run: trace one rank of every (arch x shape x mesh) cell.

The reference lowers and compiles each cell on 512 fake XLA devices. Here one
process plays rank 0 of the production mesh on the ``meta`` device, where
tensors carry shapes and no data, so nothing is allocated and no kernel runs.
For each cell the dry run:

  1. joins a 256-rank (``single``: 16 x 16) or 512-rank (``multi``: the
     reference's 2 x 16 x 16, the pod axis folded into "data") process group
     of ``torch.distributed``'s ``fake`` backend (``FakeStore``) as rank 0,
     and builds the ``("data", "model")`` mesh over it
     (:func:`fake_mesh`); its collectives on meta tensors count their bytes
     and move nothing (``parallel.collectives``);
  2. builds this rank's sharded parameters, AdamW state and inputs on meta
     (``launch/specs.py``);
  3. runs the port's own train, prefill or decode step on them under
     ``FlopCounterMode`` and a byte counter (``roofline.analysis``);
  4. writes the reference's JSON record: ``status``, ``n_params``,
     ``n_active_params``, the rank's ``argument_bytes`` (parameter,
     optimizer and input shards), the traced FLOPs, bytes and collective
     bytes (``roofline``), and the ``analytic`` block
     (``roofline/analytic.py``, priced on ``h100_sxm``).

It is a static tool, like ``tools/check``: it chooses no device for a
user's data and runs on a host with no card. The serving and training
launchers never start the fake backend.

Usage:
  python -m repro_torch.launch.dryrun --arch granite_3_2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out-dir build/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.api as falcon
from repro_torch.configs import SHAPE_CELLS, get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import mesh as PM, sharding as SH
from repro_torch.roofline.analysis import BytesCounterMode, analyze_traced
from repro_torch.roofline.analytic import analytic_costs
from repro_torch.train import steps as ST

__all__ = ["fake_mesh", "run_cell", "build_step_fn", "model_flops_for", "main"]

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def fake_mesh(mesh_name: str) -> PM.Mesh:
    """Rank 0 of the production mesh ``mesh_name`` over the ``fake``
    backend, on the meta device. The process group stays joined until
    ``parallel.mesh.shutdown``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = PM.production_mesh_shape(512 if mesh_name == "multi" else 256,
                                     multi_pod=mesh_name == "multi")
    world = shape["data"] * shape["model"]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    dm = init_device_mesh("cpu", (shape["data"], shape["model"]), mesh_dim_names=PM.AXES)
    return PM.Mesh(shape, "fake", torch.device("meta"), 0, dm)


def build_step_fn(cfg: ModelConfig, cell, mesh, cs: SP.CellSpec,
                  opt_dtype: str = "float32", microbatches: int = 1):
    if cs.kind == "train":
        return ST.make_train_step(cfg, AdamWConfig(state_dtype=opt_dtype),
                                  microbatches=microbatches, mesh=mesh, placement=cs.placement)
    if cs.kind == "prefill":
        return ST.make_prefill_step(cfg, max_len=cell.seq_len)
    return ST.make_decode_step(cfg)


def model_flops_for(cs: SP.CellSpec, cell, cfg) -> float:
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    if cell.kind == "train":
        return 6.0 * cs.n_active_params * tokens
    return 2.0 * cs.n_active_params * tokens


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str | None,
             falcon_mode: str | None = None, fsdp: int | None = None,
             remat: int | None = None, parallel_style: str | None = None,
             parallel_block: int | None = None, opt_dtype: str | None = None,
             remat_policy: str | None = None, capacity_factor: float | None = None,
             microbatches: int = 1, batch_scale: int = 1,
             falcon_backend: str | None = None, tag: str = "", notes: str = "") -> dict:
    cfg = get_config(arch)
    if falcon_mode is not None:
        cfg = dataclasses.replace(cfg, falcon_mode=falcon_mode, use_falcon=falcon_mode != "off")
    for name, v in (("fsdp", fsdp), ("remat", remat), ("parallel_block", parallel_block)):
        if v is not None:
            cfg = dataclasses.replace(cfg, **{name: bool(v)})
    for name, v in (("parallel_style", parallel_style), ("remat_policy", remat_policy),
                    ("capacity_factor", capacity_factor), ("falcon_backend", falcon_backend)):
        if v is not None:
            cfg = dataclasses.replace(cfg, **{name: v})
    cell = SHAPE_CELLS[shape]
    if batch_scale != 1:
        cell = dataclasses.replace(cell, global_batch=cell.global_batch * batch_scale)
    opt_dtype = opt_dtype or "float32"
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
                 "opt_dtype": opt_dtype,
                 "falcon_mode": cfg.falcon_mode if cfg.use_falcon else "off"}
    ok, why = SP.cell_applicable(cfg, cell)
    if not ok:
        rec.update(status="skipped", reason=why)
        _emit(rec, out_dir)
        return rec
    t0 = time.time()
    try:
        mesh = fake_mesh(mesh_name)
        chips = mesh.n_devices
        cs = SP.input_specs(cfg, cell, mesh, opt_dtype=opt_dtype)
        step = build_step_fn(cfg, cell, mesh, cs, opt_dtype=opt_dtype,
                             microbatches=microbatches)
        t_build = time.time() - t0
        flops = FlopCounterMode(display=False)
        with PM.use_mesh(mesh), SH.use_parallel_style(cfg.parallel_style), \
                SH.use_placement(cs.placement), falcon.use(M.falcon_config_for(cfg)), \
                flops, BytesCounterMode() as nbytes:
            step(*cs.args)
        t_trace = time.time() - t0 - t_build
        mf = model_flops_for(cs, cell, cfg)
        rep = analyze_traced(
            flops=flops.get_total_flops(), bytes_accessed=nbytes.bytes, stats=mesh.stats,
            arch=arch, shape=shape, mesh_name=mesh_name, chips=chips, model_flops=mf,
            bytes_per_device=cs.argument_bytes, hw=H100_SXM, dtype=cfg.dtype, notes=notes)
        # analytic roofline terms, priced on the card's profile
        ac = analytic_costs(cfg, cell, MESHES[mesh_name], cs.n_params, cs.n_active_params,
                            opt_dtype=opt_dtype)
        t_c, t_m, t_l = ac.terms(H100_SXM, cfg.dtype)
        terms = {"compute": t_c, "memory": t_m, "collective": t_l}
        step_time = max(terms.values())
        rec["analytic"] = {
            "flops_dev": ac.flops, "hbm_bytes_dev": ac.hbm_bytes,
            "coll_bytes_dev": ac.coll_bytes,
            "t_compute": t_c, "t_memory": t_m, "t_collective": t_l,
            "bottleneck": max(terms, key=terms.get), "step_time": step_time,
            "model_flops": mf,
            "useful_ratio": mf / (ac.flops * chips) if ac.flops else 0.0,
            "roofline_fraction": (mf / chips) / step_time / H100_SXM.flops_for(cfg.dtype)
                                 if step_time > 0 else 0.0,
            "detail": ac.detail,
        }
        rec.update(status="ok", build_s=round(t_build, 1), trace_s=round(t_trace, 1),
                   n_params=cs.n_params, n_active_params=cs.n_active_params,
                   argument_bytes=cs.argument_bytes, argument_bytes_by=cs.arg_bytes,
                   traced_flops=rep.hlo_flops, traced_bytes=rep.hlo_bytes,
                   collective_bytes=rep.coll_bytes,
                   collective_calls=dict(mesh.stats.calls), roofline=rep.to_dict())
    except Exception as e:  # noqa: BLE001 - record the failure verbatim
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[{arch} x {shape} x {mesh_name}] FAILED: {e}")
    finally:
        PM.shutdown()
    rec["seconds"] = round(time.time() - t0, 2)
    _emit(rec, out_dir)
    return rec


def _emit(rec: dict, out_dir: str | None):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{rec['tag']}" if rec.get("tag") else (
        f"_{rec['falcon_mode']}" if rec.get("falcon_mode") not in (None, "auto") else "")
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--falcon-mode", default=None,
                    help="override: off|auto|gemm|<scheme>")
    ap.add_argument("--fsdp", type=int, default=None)
    ap.add_argument("--remat", type=int, default=None)
    ap.add_argument("--parallel-style", default=None, choices=["tp", "fsdp_only"])
    ap.add_argument("--parallel-block", type=int, default=None)
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--batch-scale", type=int, default=1)
    ap.add_argument("--falcon-backend", default=None)
    ap.add_argument("--tag", default="", help="suffix for the output record")
    ap.add_argument("--notes", default="")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPE_CELLS) if (args.all or not args.shape) else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name, args.out_dir,
                               falcon_mode=args.falcon_mode, fsdp=args.fsdp,
                               remat=args.remat, parallel_style=args.parallel_style,
                               parallel_block=args.parallel_block,
                               opt_dtype=args.opt_dtype, remat_policy=args.remat_policy,
                               capacity_factor=args.capacity_factor,
                               microbatches=args.microbatches,
                               batch_scale=args.batch_scale,
                               falcon_backend=args.falcon_backend,
                               tag=args.tag, notes=args.notes)
                print(json.dumps({k: rec.get(k) for k in
                                  ("arch", "shape", "mesh", "status", "n_params",
                                   "argument_bytes", "traced_flops", "collective_bytes",
                                   "seconds")}))
                failures += rec["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
