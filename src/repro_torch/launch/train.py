"""Training launcher: ``python -m repro_torch.launch.train --arch granite_3_2b ...``

Trains a reduced (default) or, with ``--full``, the published config on
one device with the fault-tolerant loop (``train.TrainLoop``), periodic
checkpoints and synthetic data (``data.SyntheticLMData``): random weights
from ``--seed``, AdamW under a cosine schedule, the FalconGEMM policy the
model's own (``falcon_mode``, auto by default). It runs on the card
(``--device cuda``, the default) or, with ``--device cpu``, through the
kernels' plain versions. The reference's ``--compressed-dp`` and
``--production-mesh`` need several devices and come with the training
half of multi-device (ROADMAP Queue 1 item 6b); here they raise.

    python -m repro_torch.launch.train --arch granite_3_2b --full --steps 4 --batch 4 --seq 512
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

import repro_torch.api as falcon
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step


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
                    help="multi-device: not in the port yet (raises)")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compressed-dp", action="store_true",
                    help="int8-compressed data-parallel gradients: multi-device, "
                         "not in the port yet (raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.compressed_dp or args.production_mesh:
        raise NotImplementedError("--compressed-dp and --production-mesh need several "
                                  "devices: the port trains on one (the training half of "
                                  "multi-device, ROADMAP Queue 1 item 6b)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device (pass --device cpu to run "
                           "the kernels' plain versions)")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    params = M.init_params(cfg, args.seed, device)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, opt_cfg)
    data = SyntheticLMData(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed,
                   num_codebooks=cfg.num_codebooks if cfg.frontend == "audio_codebooks" else 0),
        device=device)
    with falcon.use(M.falcon_config_for(cfg)):
        step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
        loop = TrainLoop(
            TrainLoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                            checkpoint_dir=args.checkpoint_dir, handle_sigterm=True),
            step, data, params, opt_state)
        out = loop.run()
    hist = out["history"]
    print(f"done: {out['final_step']} steps, "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
          f"stragglers={out['stragglers']} restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
