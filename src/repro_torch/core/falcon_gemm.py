"""FalconGEMM dispatch core: planning, padding and offline Combine B.

``plan(M, K, N, cfg)`` runs the Decision Module for one contraction shape:
whether an LCMA beats standard GEMM on the target hardware and which one.
The engine (``core.engine``) then runs the chosen scheme through the
configured backend (``core.backends``: the hand-written kernels of
``"cuda"``, or the generated combines of ``"torch"``) or falls back to
``torch.matmul``. Static weights can be pre-combined offline
(``precombine_weights`` / ``PlannedWeight``), removing the Combine-B stage
from serving entirely (paper §IV-C "offline Combine B"); one B̃ serves on
either backend.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading

import torch
import torch.nn.functional as F

from . import algorithms, codegen, decision as dec, plan_cache
from .hardware import HardwareProfile, get_profile
from .lcma import LCMA

log = logging.getLogger(__name__)

__all__ = ["FalconConfig", "plan", "plan_batched", "precombine_weights",
           "matmul_with_precombined", "grouped_matmul_generated",
           "grouped_matmul_with_precombined"]


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
    def fused(self) -> bool:
        """Whether the backend keeps H on chip (the fused GEMM + Combine H of
        the "cuda" kernels) or writes it to memory in f32 (the generated
        "torch" backend): the Decision Module prices what the backend runs."""
        from .backends import get_backend
        return get_backend(self.backend).fused

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
        est = dec.estimate(l, Ml, Nl, Kl, cfg.profile, dtype, fused=cfg.fused,
                           precombined_b=precombined_b)
        return dec.Decision(Ml, Nl, Kl, dtype, l,
                            dec.gemm_time(Ml, Nl, Kl, cfg.profile, dtype),
                            est.time, (est,))
    cache = key = None
    if cfg.use_plan_cache:
        cache = plan_cache.default_cache()
        key = plan_cache.plan_key(
            Ml, Kl, Nl, cfg.profile, dtype, fused=cfg.fused,
            precombined_b=precombined_b, mode=cfg.mode,
            candidates=cfg.candidates, max_grid=cfg.max_grid,
            min_speedup=cfg.min_speedup,
            accuracy_budget=cfg.accuracy_budget, quantize=cfg.quantize)
        hit = cache.lookup(key)
        if hit is not None:
            return hit
    d = dec.decide(Ml, Nl, Kl, cfg.profile, dtype,
                   candidates=cfg.candidate_schemes(), fused=cfg.fused,
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
                                   fused=cfg.fused, precombined_b=precombined_b,
                                   shared_b=shared_b)
        return dec.GroupedDecision(
            Ml, Nl, Kl, dtype, l,
            dec.gemm_time_batched(B, Ml, Nl, Kl, cfg.profile, dtype,
                                  shared_b=shared_b),
            est.time, (est,), B=B, shared_b=shared_b)
    cache = key = None
    if cfg.use_plan_cache:
        cache = plan_cache.default_cache()
        key = plan_cache.plan_key(
            Ml, Kl, Nl, cfg.profile, dtype, fused=cfg.fused,
            precombined_b=precombined_b, mode=cfg.mode,
            candidates=cfg.candidates, max_grid=cfg.max_grid,
            min_speedup=cfg.min_speedup, batch=B, shared_b=shared_b,
            accuracy_budget=cfg.accuracy_budget, quantize=cfg.quantize)
        hit = cache.lookup(key)
        if isinstance(hit, dec.GroupedDecision):
            return hit
    d = dec.decide_batched(B, Ml, Nl, Kl, cfg.profile, dtype,
                           candidates=cfg.candidate_schemes(), fused=cfg.fused,
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


def _check_precombined(ap: torch.Tensor, bt: torch.Tensor, l: LCMA, K: int,
                       what: str) -> None:
    """B̃'s reduction blocks must be those of the padded activation."""
    if ap.shape[-1] // l.k != bt.shape[-2]:
        raise ValueError(
            f"{what}: activation K={K} (padded {ap.shape[-1]}, grid k={l.k}) "
            f"does not match precombined B̃ {tuple(bt.shape)} for scheme "
            f"{l.name} {l.key}")


def _grouped_h(at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The G*R intermediate products of a grouped LCMA as ONE batched GEMM,
    H in f32: ``at`` (G, R, X, Y) against ``bt`` (R, Y, Z) shared by the
    group (the group folded into the rows of each rank's product) or
    (G, R, Y, Z) per group. Returns (G, R, X, Z)."""
    G, R, X, Y = at.shape
    if bt.ndim == 3:
        h = codegen.product(at.transpose(0, 1).reshape(R, G * X, Y), bt, torch.float32)
        return h.view(R, G, X, -1).transpose(0, 1)
    if bt.shape[0] != G:
        raise ValueError(f"grouped LCMA: group sizes differ: {tuple(at.shape)} vs "
                         f"B̃ {tuple(bt.shape)}")
    h = codegen.product(at.reshape(G * R, X, Y), bt.reshape(G * R, Y, -1), torch.float32)
    return h.view(G, R, X, -1)


def grouped_matmul_generated(a3: torch.Tensor, b: torch.Tensor, l: LCMA,
                             cfg: FalconConfig | None = None) -> torch.Tensor:
    """Grouped LCMA via the generated combines (the ``"torch"`` backend).

    a3 (G, M, K) x b [(K, N) shared | (G, K, N) per-group] -> (G, M, N).
    The group-parallel lowering: per-group Combine A (one generated combine
    over the group), Combine B hoisted ONCE when ``b`` is shared, and the
    G*R intermediate products as one batched GEMM (never G fragmented
    launches), then per-group Combine H from the f32 accumulator.
    """
    G, M, K = a3.shape
    gen = codegen.generate(l)
    at = gen.combine_a(_pad3(a3, l.m, l.k))                 # (G, R, X, Ks)
    if b.ndim == 2:
        N = b.shape[1]
        bt = gen.combine_b(_pad2(b, l.k, l.n))              # hoisted: once
    else:
        N = b.shape[2]
        bt = gen.combine_b(_pad3(b, l.k, l.n))              # (G, R, Ks, Ns)
    c = gen.stages["combine_h"](_grouped_h(at, bt), a3.dtype)
    return c[:, :M, :N]


def grouped_matmul_with_precombined(a3: torch.Tensor, bt: torch.Tensor, l: LCMA,
                                    n_logical: int,
                                    cfg: FalconConfig | None = None) -> torch.Tensor:
    """Grouped serving-path matmul against precombined B̃ (generated combines).

    ``bt`` is (R, K/k, N/n), one shared weight, or (G, R, K/k, N/n) for
    stacked per-group weights. Combine B never runs.
    """
    G, M, K = a3.shape
    gen = codegen.generate(l)
    ap = _pad3(a3, l.m, l.k)
    _check_precombined(ap, bt, l, K, "grouped_matmul_with_precombined")
    at = gen.combine_a(ap)
    c = gen.stages["combine_h"](_grouped_h(at, bt.to(at.dtype)), a3.dtype)
    return c[:, :M, :n_logical]
