"""Training launcher: ``python -m repro_torch.launch.train --arch granite_3_2b ...``

Trains a reduced (default) or, with ``--full``, the published config with
the fault-tolerant loop (``train.TrainLoop``), periodic checkpoints and
synthetic data (``data.SyntheticLMData``): random weights from ``--seed``,
AdamW under a cosine schedule, the FalconGEMM policy the model's own
(``falcon_mode``, auto by default). It runs on the card (``--device cuda``,
the default) or, with ``--device cpu``, through the kernels' plain
versions.

``--mesh DATA,MODEL`` trains on a (data, model) mesh, one process per rank,
which the launcher starts itself (``parallel.mesh.run_ranks``) unless
``RANK``/``WORLD_SIZE`` say it is one already (``torchrun``);
``--dist-backend`` is ``nccl`` (a card per rank) or ``gloo`` (ranks sharing
a card, or on the CPU). The parameters are placed by the reference's rule
table, ``make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)``:
ZeRO-3 over "data" where ``cfg.fsdp`` (the published configs; the smoke
configs replicate), tensor parallelism over "model". ``--compressed-dp``
runs the int8-compressed data-parallel step instead (parameters
replicated). ``--production-mesh`` asks for the reference's 16 x 16 mesh
and raises on a world of any other size than 256. Rank 0 prints.

    python -m repro_torch.launch.train --arch granite_3_2b --full --steps 4 --batch 4 --seq 512
    python -m repro_torch.launch.train --arch granite_3_2b --device cpu --mesh 2,1 --compressed-dp
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import sys
import tempfile

import torch

import repro_torch.api as falcon
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.serve import _parse_mesh, _print_collectives
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import mesh as PM, sharding as SH
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step
from repro_torch.train.steps import make_compressed_dp_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced same-family config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16 x 16 mesh: needs 256 ranks")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compressed-dp", action="store_true",
                    help="int8-compressed data-parallel gradient all-reduce")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh, e.g. --mesh 2,1: one process "
                         "per rank, started by the launcher unless RANK/WORLD_SIZE are "
                         "set (torchrun)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (--mesh): nccl where every rank "
                         "has a card, gloo where ranks share one or run on the CPU "
                         "(default: by the visible cards)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device (pass --device cpu to run "
                           "the kernels' plain versions)")
    args.mesh_shape = _parse_mesh(args.mesh)
    world = int(os.environ["WORLD_SIZE"]) if "RANK" in os.environ else \
        math.prod(args.mesh_shape.values()) if args.mesh_shape else 1
    if args.production_mesh:
        args.mesh_shape = PM.production_mesh_shape(world)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if world <= 1:
        return _train(args, None)
    backend = args.dist_backend or PM.choose_backend(args.device, world)
    if "RANK" not in os.environ:
        # one process per rank, each joined through a file store of its own
        return PM.run_ranks(_train_rank, args.mesh_shape, args, backend=backend,
                            device=args.device, timeout=None)[0]
    mesh = PM.init_mesh(args.mesh_shape, backend, device=args.device)   # torchrun's rank
    try:
        return _train_rank(mesh, args)
    finally:
        PM.shutdown()


def _train_rank(mesh, args) -> dict:
    """This process as one rank of ``--mesh``: it trains as every rank does,
    and prints only if it is rank 0."""
    with contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else open(os.devnull, "w")):
        print(f"mesh: {mesh.shape} over {mesh.n_devices} ranks, backend {mesh.backend}"
              f"{' (staged through pinned host memory)' if mesh.staged else ''}")
        return _train(args, mesh)


def _train(args, mesh) -> dict:
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    device = mesh.device if mesh is not None else torch.device(args.device)
    params = M.init_params(cfg, args.seed, device)
    opt_cfg = AdamWConfig(lr=args.lr)
    rules = placement = None
    batch_spec = ("data",)
    if mesh is not None and args.compressed_dp:
        rules = SH.ShardingRules((), batch_spec)          # every leaf replicated
    elif mesh is not None:
        rules = SH.make_rules(mesh, fsdp=cfg.fsdp, style=cfg.parallel_style)
        placement = SH.param_sharding(params, mesh, rules, cfg)
        params = SH.shard_params(params, cfg, mesh, rules)
        batch_spec = SH.loss_axes(cfg.parallel_style)
    opt_state = adamw_init(params, opt_cfg)
    data = SyntheticLMData(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed,
                   num_codebooks=cfg.num_codebooks if cfg.frontend == "audio_codebooks" else 0),
        device=device, mesh=mesh, batch_spec=batch_spec)
    with falcon.use(M.falcon_config_for(cfg)), PM.use_mesh(mesh):
        if mesh is not None and args.compressed_dp:
            step = make_compressed_dp_train_step(cfg, opt_cfg, mesh, total_steps=args.steps)
        else:
            step = make_train_step(cfg, opt_cfg, total_steps=args.steps, mesh=mesh,
                                   placement=placement)
        loop = TrainLoop(
            TrainLoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                            checkpoint_dir=args.checkpoint_dir, handle_sigterm=True),
            step, data, params, opt_state, mesh=mesh, placement=placement, rules=rules,
            model_cfg=cfg)
        out = loop.run()
    hist = out["history"]
    print(f"done: {out['final_step']} steps, "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
          f"stragglers={out['stragglers']} restarts={out['restarts']}")
    if mesh is not None:
        _print_collectives(mesh.summary())
    return out


if __name__ == "__main__":
    main()
