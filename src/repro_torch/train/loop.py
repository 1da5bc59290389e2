"""Fault-tolerant training loop.

Behaviours (each tested with injected faults):
  * checkpoint/restart — periodic async checkpoints through
    ``checkpoint.CheckpointManager``; on a step failure the loop restores
    the last checkpoint and replays (the data pipeline is a pure function
    of the step, so the replay is exact);
  * bounded retry — repeated failures at one step abort with a clear error
    instead of looping forever;
  * preemption — SIGTERM or :meth:`TrainLoop.preempt` triggers a final
    synchronous checkpoint and a clean exit (a restart picks up at the same
    step);
  * straggler detection — each step's wall time (the card synchronized
    before the clock is read) against a running EMA; slow steps are counted
    and surfaced in the result.

Checkpoints hold ``{"params", "opt_state"}`` in the reference's format, so
a run the reference's loop checkpointed resumes here (and the reverse).
On a mesh (``mesh``, ``rules``, the model's ``model_cfg`` and the params'
``placement``) the shards are gathered whole to rank 0 for each save, and
a restore narrows the whole arrays to this rank's placement under
``rules``: a run saved on 2 x 1 resumes on 1 x 2 or on one device.
The train step updates the parameters and optimizer state in place; a
failure inside it leaves them as far as it got, and the restore replaces
them.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree import tree_leaves, tree_map

log = logging.getLogger(__name__)

__all__ = ["TrainLoopConfig", "TrainLoop", "FaultInjector"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 3
    max_retries_per_step: int = 2
    straggler_factor: float = 3.0     # step slower than factor*EMA => straggler
    ema_decay: float = 0.9
    log_every: int = 10
    handle_sigterm: bool = False      # opt-in: don't take over signals in tests


class FaultInjector:
    """Deterministic fault injection for tests: raise at given steps."""

    def __init__(self, fail_at: dict[int, int] | None = None):
        self.fail_at = dict(fail_at or {})  # step -> remaining failures

    def maybe_fail(self, step: int):
        if self.fail_at.get(step, 0) > 0:
            self.fail_at[step] -= 1
            raise RuntimeError(f"injected fault at step {step}")


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, train_step: Callable, data, params,
                 opt_state, fault_injector: FaultInjector | None = None,
                 warm_fn: Callable | None = None, mesh=None, placement=None, rules=None,
                 model_cfg=None):
        self.cfg = cfg
        self.train_step = train_step
        self.data = data
        self.params = params
        self.opt_state = opt_state
        self.faults = fault_injector
        # Optional warm pass (e.g. ``lambda: steps.warm_train(cfg, B, S)``):
        # pre-plans the forward and backward shapes, so the first step's
        # Decision-Module queries are plan-cache hits.
        self.warm_fn = warm_fn
        self.rules, self.model_cfg = rules, model_cfg
        pl = placement if placement is not None else tree_map(lambda _: (), params)
        state_placement = None if mesh is None else {
            "params": pl, "opt_state": {"m": pl, "v": pl, "step": ()}}
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints,
                                      mesh=mesh, placement=state_placement)
        self.metrics_history: list[dict] = []
        self.stragglers = 0
        self.restarts = 0
        self._preempted = False
        if cfg.handle_sigterm:  # pragma: no cover - signal path
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, *_):  # pragma: no cover
        self._preempted = True

    def preempt(self):
        """Programmatic preemption (tests / orchestrator hook)."""
        self._preempted = True

    # -- checkpoint plumbing ------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _device(self) -> torch.device:
        leaves = tree_leaves(self.params)
        return leaves[0].device if leaves else torch.device("cpu")

    def _save(self, step: int, sync: bool = False):
        self.ckpt.async_save = not sync
        self.ckpt.save(step, self._state(), extra={"step": step})
        if sync:
            self.ckpt.wait()

    def _restore(self) -> int:
        state, step, _ = self.ckpt.restore_latest(self._state(), device=self._device(),
                                                  rules=self.rules, cfg=self.model_cfg)
        self.params, self.opt_state = state["params"], state["opt_state"]
        return step

    # -- main loop ----------------------------------------------------------
    def run(self, start_step: int = 0) -> dict:
        if self.warm_fn is not None:
            log.info("warm pass: %s plans made before the first step", self.warm_fn())
        step = start_step
        ema = None
        retries = 0
        while step < self.cfg.total_steps:
            if self._preempted:
                log.warning("preemption: checkpointing at step %d and exiting", step)
                self._save(step, sync=True)
                break
            t0 = time.perf_counter()
            try:
                if self.faults:
                    self.faults.maybe_fail(step)
                batch = self.data.batch(step)
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch, step)
                if metrics["loss"].is_cuda:
                    torch.cuda.synchronize(metrics["loss"].device)
            except Exception as e:  # noqa: BLE001 - any step failure is retryable
                retries += 1
                self.restarts += 1
                if retries > self.cfg.max_retries_per_step:
                    raise RuntimeError(f"step {step} failed {retries} times; aborting") from e
                try:
                    restored = self._restore()
                    log.warning("step %d failed (%s); restored checkpoint@%d", step, e, restored)
                    step = restored
                except FileNotFoundError:
                    log.warning("step %d failed (%s); no checkpoint, retrying", step, e)
                continue
            retries = 0
            dt = time.perf_counter() - t0
            if ema is not None and dt > self.cfg.straggler_factor * ema:
                self.stragglers += 1
                log.warning("straggler step %d: %.3fs vs EMA %.3fs", step, dt, ema)
            ema = dt if ema is None else self.cfg.ema_decay * ema + (1 - self.cfg.ema_decay) * dt
            rec = {"step": step, "time": dt, "loss": float(metrics["loss"])}
            self.metrics_history.append(rec)
            if step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, rec["loss"], dt)
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self._save(step)
        self.ckpt.wait()
        return {"final_step": step, "stragglers": self.stragglers,
                "restarts": self.restarts, "history": self.metrics_history}
