"""FalconGEMM dispatch core: planning, padding and offline Combine B.

``plan(M, K, N, cfg)`` runs the Decision Module for one contraction shape:
whether an LCMA beats standard GEMM on the target hardware and which one.
The engine (``core.engine``) then runs the chosen scheme through the
configured backend (``core.backends``) or falls back to ``torch.matmul``.
Static weights can be pre-combined offline (``precombine_weights`` /
``PlannedWeight``), removing the Combine-B stage from serving entirely
(paper §IV-C "offline Combine B").
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading

import torch
import torch.nn.functional as F

from . import algorithms, decision as dec, plan_cache
from .hardware import HardwareProfile, get_profile
from .lcma import LCMA

log = logging.getLogger(__name__)

__all__ = ["FalconConfig", "plan", "plan_batched", "precombine_weights",
           "matmul_with_precombined"]


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    """Dispatch policy for FalconGEMM."""

    enabled: bool = True
    hardware: str = "h100_sxm"
    backend: str = "cuda"            # any name in core.backends registry
    mode: str = "auto"               # "auto" | "gemm" | explicit scheme name
    candidates: tuple[str, ...] | None = None
    min_speedup: float = 1.02        # require a predicted >=2% win before switching
    max_grid: int = 5
    # Static numerical-accuracy ceiling for this call site: candidates whose
    # Higham-style relative-error bound (``LCMA.stability.error_bound``)
    # exceeds the budget are rejected BEFORE pricing. None disables.
    accuracy_budget: float | None = None
    # Put the int8-quantized tier into the Decision Module's search: every
    # budget-eligible candidate is additionally priced quantized
    # (``decision.estimate_quant``) and the winner's tier lands in
    # ``Decision.precision``. PlannedWeights then also carry int8 B̃q.
    quantize: bool = False
    # Per-device scaling of (M, K, N): number of shards per dim.
    shards: tuple[int, int, int] = (1, 1, 1)
    # Memoize auto-mode Decisions in the process plan cache.
    use_plan_cache: bool = True

    @property
    def profile(self) -> HardwareProfile:
        return get_profile(self.hardware)

    def candidate_schemes(self) -> list[LCMA]:
        if self.candidates is not None:
            return [algorithms.get(n) for n in self.candidates]
        return algorithms.candidates(max_grid=self.max_grid)


# Once-per-key warning dedup for non-divisible shard shapes, bounded (LRU)
# and locked: plan() may be reached from several threads.
_WARNED_SHARDS_MAX = 512
_warned_shards: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
_warned_shards_lock = threading.Lock()


def _warn_once_key(key: tuple) -> bool:
    """True if ``key`` has not warned yet; records it in the bounded LRU."""
    with _warned_shards_lock:
        if key in _warned_shards:
            _warned_shards.move_to_end(key)
            return False
        _warned_shards[key] = None
        if len(_warned_shards) > _WARNED_SHARDS_MAX:
            _warned_shards.popitem(last=False)
        return True


def _local_shape(M: int, K: int, N: int, cfg: FalconConfig) -> tuple[int, int, int]:
    """Scale a global shape to the per-device shape by ``cfg.shards``.

    Non-divisible shards round UP (ceil division): the per-device problem a
    partitioner actually materializes is the padded shard. Warns once per
    (shape, shards).
    """
    sm, sk, sn = cfg.shards
    if min(sm, sk, sn) < 1:
        raise ValueError(f"FalconConfig.shards must be >= 1, got {cfg.shards}")
    if M % sm or K % sk or N % sn:
        key = (M, K, N, cfg.shards)
        if _warn_once_key(key):
            log.warning(
                "FalconGEMM: shards %s do not divide (M=%d, K=%d, N=%d); "
                "pricing the rounded-up per-device shard (%d, %d, %d)",
                cfg.shards, M, K, N, -(-M // sm), -(-K // sk), -(-N // sn))
    return max(-(-M // sm), 1), max(-(-K // sk), 1), max(-(-N // sn), 1)


def plan(M: int, K: int, N: int, cfg: FalconConfig, dtype: str = "bfloat16",
         precombined_b: bool = False) -> dec.Decision:
    """Run the Decision Module for a matmul shape.

    Auto-mode decisions are memoized in the process plan cache (keyed on the
    local shape, dtype, hardware fingerprint and dispatch policy). A forced
    scheme (``cfg.mode`` = a scheme name) is taken without the Eq. 8 guard.
    """
    Ml, Kl, Nl = _local_shape(M, K, N, cfg)
    if cfg.mode == "gemm" or not cfg.enabled:
        t = dec.gemm_time(Ml, Nl, Kl, cfg.profile, dtype)
        return dec.Decision(Ml, Nl, Kl, dtype, None, t, None, ())
    if cfg.mode != "auto":
        l = algorithms.get(cfg.mode)
        est = dec.estimate(l, Ml, Nl, Kl, cfg.profile, dtype,
                           precombined_b=precombined_b)
        return dec.Decision(Ml, Nl, Kl, dtype, l,
                            dec.gemm_time(Ml, Nl, Kl, cfg.profile, dtype),
                            est.time, (est,))
    cache = key = None
    if cfg.use_plan_cache:
        cache = plan_cache.default_cache()
        key = plan_cache.plan_key(
            Ml, Kl, Nl, cfg.profile, dtype,
            precombined_b=precombined_b, mode=cfg.mode,
            candidates=cfg.candidates, max_grid=cfg.max_grid,
            min_speedup=cfg.min_speedup,
            accuracy_budget=cfg.accuracy_budget, quantize=cfg.quantize)
        hit = cache.lookup(key)
        if hit is not None:
            return hit
    d = dec.decide(Ml, Nl, Kl, cfg.profile, dtype,
                   candidates=cfg.candidate_schemes(),
                   precombined_b=precombined_b, min_speedup=cfg.min_speedup,
                   accuracy_budget=cfg.accuracy_budget, quantize=cfg.quantize)
    if cache is not None:
        cache.insert(key, d)
    return d


def plan_batched(B: int, M: int, K: int, N: int, cfg: FalconConfig,
                 dtype: str = "bfloat16", precombined_b: bool = False,
                 shared_b: bool = False) -> dec.GroupedDecision:
    """Run the Decision Module for a grouped batched contraction.

    One decision — and ONE plan-cache key (``gBxMxKxN``) — for the whole
    ``B x (M, K) @ (K, N)`` group. Combine B is priced once when the B
    operand is shared (``shared_b=True``) and the R*B intermediate products
    are priced as one grouped GEMM. ``cfg.shards`` scales the per-element
    (M, K, N); the group dim is not sharded here.
    """
    Ml, Kl, Nl = _local_shape(M, K, N, cfg)
    B = int(B)
    if B < 1:
        raise ValueError(f"plan_batched: group size must be >= 1, got {B}")
    if cfg.mode == "gemm" or not cfg.enabled:
        t = dec.gemm_time_batched(B, Ml, Nl, Kl, cfg.profile, dtype,
                                  shared_b=shared_b)
        return dec.GroupedDecision(Ml, Nl, Kl, dtype, None, t, None, (),
                                   B=B, shared_b=shared_b)
    if cfg.mode != "auto":
        l = algorithms.get(cfg.mode)
        est = dec.estimate_grouped(l, B, Ml, Nl, Kl, cfg.profile, dtype,
                                   precombined_b=precombined_b, shared_b=shared_b)
        return dec.GroupedDecision(
            Ml, Nl, Kl, dtype, l,
            dec.gemm_time_batched(B, Ml, Nl, Kl, cfg.profile, dtype,
                                  shared_b=shared_b),
            est.time, (est,), B=B, shared_b=shared_b)
    cache = key = None
    if cfg.use_plan_cache:
        cache = plan_cache.default_cache()
        key = plan_cache.plan_key(
            Ml, Kl, Nl, cfg.profile, dtype,
            precombined_b=precombined_b, mode=cfg.mode,
            candidates=cfg.candidates, max_grid=cfg.max_grid,
            min_speedup=cfg.min_speedup, batch=B, shared_b=shared_b,
            accuracy_budget=cfg.accuracy_budget, quantize=cfg.quantize)
        hit = cache.lookup(key)
        if isinstance(hit, dec.GroupedDecision):
            return hit
    d = dec.decide_batched(B, Ml, Nl, Kl, cfg.profile, dtype,
                           candidates=cfg.candidate_schemes(),
                           precombined_b=precombined_b, shared_b=shared_b,
                           min_speedup=cfg.min_speedup,
                           accuracy_budget=cfg.accuracy_budget,
                           quantize=cfg.quantize)
    if cache is not None:
        cache.insert(key, d)
    return d


def _pad2(x: torch.Tensor, d0: int, d1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % d0
    p1 = (-x.shape[1]) % d1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def _pad3(x: torch.Tensor, d0: int, d1: int) -> torch.Tensor:
    p0 = (-x.shape[1]) % d0
    p1 = (-x.shape[2]) % d1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


# ---------------------------------------------------------------------------
# Offline Combine B (static weights, serving path)
# ---------------------------------------------------------------------------

def precombine_weights(w: torch.Tensor, l: LCMA) -> torch.Tensor:
    """Offline Combine B of a static weight: (K, N) -> (R, K/k, N/n), or a
    stack (L, K, N) -> (L, R, K/k, N/n) in one grouped launch.

    This is the kernel pipeline's own ``group_combine`` with ``l.V``, so B̃
    has exactly the layout the fused kernel reads.
    """
    from repro_torch.kernels.group_combine import (batched_group_combine,
                                                   group_combine)
    if w.ndim == 2:
        return group_combine(_pad2(w, l.k, l.n).contiguous(), l.V)
    return batched_group_combine(_pad3(w, l.k, l.n).contiguous(), l.V)


def matmul_with_precombined(a: torch.Tensor, bt: torch.Tensor, l: LCMA,
                            n_logical: int) -> torch.Tensor:
    """Serving-path matmul against pre-combined weights B̃ (R, K/k, N/n).

    ``a`` is (..., M, K); the leading dims are flattened into M.
    """
    from repro_torch.kernels.ops import falcon_matmul_precombined
    *lead, M, K = a.shape
    c = falcon_matmul_precombined(a.reshape(-1, K), bt, l, n_logical)
    return c.reshape(*lead, M, n_logical)
