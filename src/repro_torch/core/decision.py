"""Decision Module: analytical LCMA selection (paper §III-C, Table II).

Given ``(M, N, K)``, a dtype and a ``HardwareProfile``, iterate the candidate
set ``S_LCMA`` and pick the scheme with the best predicted runtime, or fall
back to standard GEMM. The model is the paper's per-stage arithmetic-intensity
analysis:

  standard GEMM:   AI = 2MNK / (MK + NK + MN)           (Eq. 8 guard)
  Combine A:       flops = (|U|0 - R) * (M/m)(K/k),  bytes = MK (1 + R/(mk))
  Combine B:       flops = (|V|0 - R) * (K/k)(N/n),  bytes = NK (1 + R/(nk))
  GEMM stage:      flops = 2RMNK/(mkn),               bytes = R(MK/mk + NK/nk + MN/mn)
  Combine H:       flops = (|W|0 - mn) * (M/m)(N/n),  bytes = MN (1 + R/(mn))

With the fused GEMM+Combine-H of Algorithm 2 (``fused=True``, the
pipeline the ``"cuda"`` kernels run), H never reaches HBM: the fused stage
writes C once (MN) and the R/mn overhead term vanishes (Eq. 9 -> 10).
``fused=False`` prices the pipeline of the generated ``"torch"`` backend:
the GEMM stage writes H and Combine H reads it back, in f32 (the
accumulator, ``H_BYTES``), where the reference prices H in the operand
dtype. ``FalconConfig.fused`` says which one a backend runs.

Each stage's time is ``max(compute_time, memory_time)`` — the roofline model
of compute/memory pipeline overlap *within* a stage; stages are serialized
(the paper notes Combine A cannot fully overlap the GEMM, §IV-E).

Padding honesty: LCMA requires dimensions divisible by the grid; the model
charges the *padded* problem for LCMA while standard GEMM runs unpadded, so
boundary waste is priced into the decision.
"""
from __future__ import annotations

import dataclasses

from . import algorithms
from .hardware import HardwareProfile, get_profile
from .lcma import LCMA

__all__ = ["StageCost", "LCMAEstimate", "Decision", "GroupedDecision",
           "gemm_time", "estimate", "lcma_time", "decide",
           "eq8_is_memory_bound", "eq10_profitable",
           "gemm_time_batched", "estimate_grouped",
           "decide_batched", "batched_is_memory_bound",
           "estimate_quant", "estimate_grouped_quant"]


@dataclasses.dataclass(frozen=True)
class StageCost:
    name: str
    flops: float
    bytes: float
    compute_time: float
    memory_time: float

    @property
    def time(self) -> float:
        return max(self.compute_time, self.memory_time)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_time >= self.memory_time else "memory"

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


@dataclasses.dataclass(frozen=True)
class LCMAEstimate:
    lcma: LCMA
    stages: tuple[StageCost, ...]
    padded_shape: tuple[int, int, int]
    precision: str = "fp"        # "fp" (io dtype) or "int8" (quantized tier)

    @property
    def time(self) -> float:
        return sum(s.time for s in self.stages)


@dataclasses.dataclass(frozen=True)
class Decision:
    M: int
    N: int
    K: int
    dtype: str
    algo: LCMA | None            # None => standard GEMM
    gemm_seconds: float
    lcma_seconds: float | None
    estimates: tuple[LCMAEstimate, ...]
    precision: str = "fp"        # "fp" or "int8": the winning tier's precision

    @property
    def use_lcma(self) -> bool:
        return self.algo is not None

    @property
    def quantized(self) -> bool:
        return self.use_lcma and self.precision == "int8"

    @property
    def speedup(self) -> float:
        if self.lcma_seconds is None:
            return 1.0
        return self.gemm_seconds / self.lcma_seconds

    @property
    def seconds(self) -> float:
        return self.lcma_seconds if self.use_lcma else self.gemm_seconds


@dataclasses.dataclass(frozen=True)
class GroupedDecision(Decision):
    """A Decision for a grouped batched contraction ``B x [(M, K) @ (K, N)]``.

    ``M/N/K`` are the *per-group-element* shape; ``B`` is the group size.
    ``shared_b=True`` marks the broadcast-B case (one (K, N) operand shared by
    every group element — attention weights, PlannedWeights, any ``vmap`` with
    a closed-over matrix): Combine B is then priced ONCE for the whole group
    (the paper's Group-Parallel amortization), not B times.
    """

    B: int = 1
    shared_b: bool = False

    @property
    def hoists_combine_b(self) -> bool:
        """True when the grouped lowering runs Combine B once for the group."""
        return self.use_lcma and self.shared_b and self.B > 1


_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1}


def _dtype_bytes(dtype: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is not None:
        return b
    # torch knows the extended types numpy alone does not (float8_e4m3fn &
    # friends). Lazy import keeps the decision model importable without torch.
    import torch
    tdt = getattr(torch, str(dtype), None)
    if not isinstance(tdt, torch.dtype):
        raise ValueError(
            f"decision model: unknown dtype {dtype!r}; pass a torch dtype "
            f"name (e.g. 'bfloat16', 'float8_e4m3fn', 'int32')")
    b = torch.empty((), dtype=tdt).element_size()
    _DTYPE_BYTES[dtype] = b
    return b


def _pad_up(x: int, d: int) -> int:
    return ((x + d - 1) // d) * d


def _resolve_hw(hw: HardwareProfile | str) -> HardwareProfile:
    """Accept a profile by name so calibrated (autotuned) profiles written to
    disk by an autotuner are consumed transparently."""
    return get_profile(hw) if isinstance(hw, str) else hw


def _filter_by_budget(candidates: list[LCMA], accuracy_budget: float | None,
                      dtype: str) -> list[LCMA]:
    """Drop candidates whose static error bound exceeds the budget.

    ``accuracy_budget`` is an absolute relative-error ceiling for the call
    site (same units as ``SchemeStability.error_bound``: a multiple of 1.0,
    not of ulp). ``None`` disables the filter. The bound comes from the
    ``stability`` pass of falcon-check (Higham-style growth computed from the
    coefficient tensors alone), so rejection is static — no kernel runs, no
    sampling.
    """
    if accuracy_budget is None:
        return candidates
    return [l for l in candidates
            if l.stability.within_budget(accuracy_budget, dtype)]


def gemm_time(M: int, N: int, K: int, hw: HardwareProfile | str,
              dtype: str = "bfloat16") -> float:
    """Standard GEMM roofline time (Eq. 8 dichotomy)."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    flops = 2.0 * M * N * K
    mem = (M * K + K * N + M * N) * by
    return max(flops / hw.flops_for(dtype), mem / hw.beta)


def eq8_is_memory_bound(M: int, N: int, K: int, hw: HardwareProfile | str,
                        dtype: str = "bfloat16") -> bool:
    """Paper Eq. 8: when standard GEMM is memory-bound, no LCMA can win."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    ai = 2.0 * M * N * K / ((M * K + K * N + M * N) * by)
    return ai <= hw.flops_for(dtype) / hw.beta


# Bytes per element of a materialized H (fused=False): the f32 accumulator
# the generated backend's product writes.
H_BYTES = 4


def estimate(l: LCMA, M: int, N: int, K: int, hw: HardwareProfile | str,
             dtype: str = "bfloat16", fused: bool = True,
             precombined_b: bool = False) -> LCMAEstimate:
    """Per-stage cost of one LCMA application (Table II + fused correction)."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    m, k, n, R = l.m, l.k, l.n, l.R
    # LCMA pays for padding to grid multiples.
    Mp, Kp, Np = _pad_up(M, m), _pad_up(K, k), _pad_up(N, n)
    Ms, Ks, Ns = Mp // m, Kp // k, Np // n
    Fa = hw.flops_add
    Fx = hw.flops_for(dtype) * hw.lcma_gemm_efficiency
    stages = []

    def stage(name, flops, nbytes, unit):
        stages.append(StageCost(name, flops, nbytes, flops / unit, nbytes / hw.beta))

    stage("combine_a", (l.nnz_u - R) * Ms * Ks, (Mp * Kp + R * Ms * Ks) * by, Fa)
    if not precombined_b:
        stage("combine_b", (l.nnz_v - R) * Ks * Ns, (Kp * Np + R * Ks * Ns) * by, Fa)
    gemm_flops = 2.0 * R * Ms * Ns * Ks
    if fused:
        # Fused GEMM + Combine H: H stays on-chip; write C exactly once.
        stage("gemm+combine_h", gemm_flops, (R * (Ms * Ks + Ks * Ns) + Mp * Np) * by, Fx)
    else:
        # H written by the product and read back by Combine H, in f32.
        stage("gemm", gemm_flops, R * (Ms * Ks + Ks * Ns) * by + R * Ms * Ns * H_BYTES, Fx)
        stage("combine_h", (l.nnz_w - m * n) * Ms * Ns,
              Mp * Np * by + R * Ms * Ns * H_BYTES, Fa)
    return LCMAEstimate(l, tuple(stages), (Mp, Np, Kp))


def lcma_time(l: LCMA, M: int, N: int, K: int, hw: HardwareProfile, **kw) -> float:
    """Predicted seconds of one LCMA application (the sum of its stages)."""
    return estimate(l, M, N, K, hw, **kw).time


def eq10_profitable(l: LCMA, M: int, N: int, K: int, hw: HardwareProfile | str,
                    dtype: str = "bfloat16") -> bool:
    """Paper Eq. 10 closed form (fused; combine stages memory-bound regime)."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    m, k, n, R = l.m, l.k, l.n, l.R
    num = 2.0 * M * N * K * (1.0 - R / (m * n * k))
    den = (M * K * (1 + R / (m * k)) + N * K * (1 + R / (n * k)) + M * N) * by
    return num / den > hw.flops_for(dtype) / hw.beta


# ---------------------------------------------------------------------------
# Quantized (int8) tier (paper §IV-C: quantization fused into the Combines)
#
# The quantized pipeline (kernels/quant_combine.py) folds symmetric 127-level
# block-scaled quantization into Combine A/B, runs the R-batched GEMM on int8
# operands with an int32 accumulator, and dequantizes inside the fused
# Combine-H epilogue. The cost model prices that pipeline:
#
#   * combine stages pay the quant pass (abs-max + scale) in flops, write the
#     combined operand as int8 (1 B/elem) plus f32 scales (one per reduction
#     block of _QUANT_BLOCK elements);
#   * the GEMM stage reads int8 operands at the profile's int8 throughput
#     (``hw.flops_for("int8")``; flops_mul when the profile has none);
#   * the output is written once in the io dtype (dequantized on-chip).
#
# Eq. 8 deliberately does NOT gate this tier: the guard models same-dtype
# traffic, and int8 operands cut the memory side, so a memory-bound fp GEMM
# can still be a quantized-LCMA win. Selection is instead gated by the
# accuracy budget: the static int8 error bound (stability pass, eps =
# 1/(2*127)) must fit the caller's ``accuracy_budget``.
# ---------------------------------------------------------------------------

# Reduction-block depth of the block-scaled quantization (kernel default).
_QUANT_BLOCK = 128


def _quant_eligible(l: LCMA, accuracy_budget: float | None) -> bool:
    """Static eligibility of scheme ``l`` for the int8 tier.

    Requires (a) the quant reduction block cannot overflow the int32
    accumulator, and (b) when a budget is set, the scheme's int8 error bound
    fits it. Import is lazy: ``repro_torch.analysis`` imports ``core``.
    """
    from repro_torch.analysis import stability as _stab
    if _QUANT_BLOCK > _stab.max_safe_accum_depth(32):
        return False
    if accuracy_budget is None:
        return True
    return l.stability.within_budget(accuracy_budget, "int8")


def estimate_quant(l: LCMA, M: int, N: int, K: int,
                   hw: HardwareProfile | str, dtype: str = "bfloat16",
                   precombined_b: bool = False) -> LCMAEstimate:
    """Per-stage cost of one *quantized* LCMA application.

    ``dtype`` is the io dtype (A input, C output); the combined operands move
    as int8 with f32 block scales. ``precombined_b=True`` models an
    offline-quantized B̃q (the PlannedWeight path): no Combine-B stage, int8
    B traffic only.
    """
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    m, k, n, R = l.m, l.k, l.n, l.R
    Mp, Kp, Np = _pad_up(M, m), _pad_up(K, k), _pad_up(N, n)
    Ms, Ks, Ns = Mp // m, Kp // k, Np // n
    Ksb = -(-Ks // _QUANT_BLOCK)       # scale blocks along the reduction
    Fa = hw.flops_add
    Fq = hw.flops_for("int8") * hw.lcma_gemm_efficiency
    stages = []

    def stage(name, flops, nbytes, unit):
        stages.append(StageCost(name, flops, nbytes, flops / unit, nbytes / hw.beta))

    # Combine A + quantize: combine flops plus the quant pass (abs-max scan
    # and scale multiply, ~2 ops/elem of the combined tensor); reads fp A,
    # writes int8 Ã plus one f32 scale per block.
    stage("combine_a+quant",
          (l.nnz_u - R) * Ms * Ks + 2.0 * R * Ms * Ks,
          Mp * Kp * by + R * Ms * Ks + R * Ms * Ksb * 4, Fa)
    if not precombined_b:
        stage("combine_b+quant",
              (l.nnz_v - R) * Ks * Ns + 2.0 * R * Ks * Ns,
              Kp * Np * by + R * Ks * Ns + R * Ksb * Ns * 4, Fa)
    # Fused int8 GEMM + dequantizing Combine H: int8 operands (1 B/elem),
    # f32 scales, one fp output write.
    stage("gemm+combine_h[int8]", 2.0 * R * Ms * Ns * Ks,
          R * (Ms * Ks + Ks * Ns) + R * (Ms * Ksb + Ksb * Ns) * 4
          + Mp * Np * by, Fq)
    return LCMAEstimate(l, tuple(stages), (Mp, Np, Kp), precision="int8")


def estimate_grouped_quant(l: LCMA, B: int, M: int, N: int, K: int,
                           hw: HardwareProfile | str, dtype: str = "bfloat16",
                           precombined_b: bool = False,
                           shared_b: bool = False) -> LCMAEstimate:
    """Grouped analogue of :func:`estimate_quant` (see :func:`estimate_grouped`
    for the B-scaling and ``eff_B`` launch-amortization model)."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    m, k, n, R = l.m, l.k, l.n, l.R
    Mp, Kp, Np = _pad_up(M, m), _pad_up(K, k), _pad_up(N, n)
    Ms, Ks, Ns = Mp // m, Kp // k, Np // n
    Ksb = -(-Ks // _QUANT_BLOCK)
    nb = 1 if shared_b else B
    Fa = hw.flops_add
    eff = hw.lcma_gemm_efficiency
    eff_b = B * eff / (B * eff + 1.0 - eff)
    Fq = hw.flops_for("int8") * eff_b
    stages = []

    def stage(name, flops, nbytes, unit):
        stages.append(StageCost(name, flops, nbytes, flops / unit, nbytes / hw.beta))

    stage("combine_a+quant",
          ((l.nnz_u - R) * Ms * Ks + 2.0 * R * Ms * Ks) * B,
          (Mp * Kp * by + R * Ms * Ks + R * Ms * Ksb * 4) * B, Fa)
    if not precombined_b:
        stage("combine_b+quant",
              ((l.nnz_v - R) * Ks * Ns + 2.0 * R * Ks * Ns) * nb,
              (Kp * Np * by + R * Ks * Ns + R * Ksb * Ns * 4) * nb, Fa)
    stage("gemm+combine_h[int8]", 2.0 * R * Ms * Ns * Ks * B,
          B * (R * Ms * Ks + R * Ms * Ksb * 4 + Mp * Np * by)
          + nb * (R * Ks * Ns + R * Ksb * Ns * 4), Fq)
    return LCMAEstimate(l, tuple(stages), (Mp, Np, Kp), precision="int8")


def decide(M: int, N: int, K: int, hw: HardwareProfile | str, dtype: str = "bfloat16",
           candidates: list[LCMA] | None = None, fused: bool = True,
           precombined_b: bool = False,
           min_speedup: float = 1.0,
           accuracy_budget: float | None = None,
           quantize: bool = False) -> Decision:
    """Select the best LCMA for (M, N, K) or fall back to standard GEMM.

    ``hw`` may be a ``HardwareProfile`` or a profile *name*; names resolve
    through ``hardware.get_profile``, which also finds calibrated profiles
    written to disk by an autotuner.

    ``accuracy_budget`` statically rejects candidates whose Higham-style
    error bound (``l.stability.error_bound(dtype)``) exceeds the given
    relative-error ceiling; filtered-out schemes never get priced, so a
    numerically aggressive scheme cannot win on speed alone.

    ``quantize=True`` additionally prices every budget-eligible candidate's
    int8 tier (:func:`estimate_quant`) and picks the best (scheme, precision)
    pair jointly; the winner's tier is reported in ``Decision.precision``.
    The Eq. 8 fast path only skips the *fp* estimates — the quantized tier
    moves less operand traffic, so it stays in the running even when the fp
    GEMM is memory-bound.
    """
    hw = _resolve_hw(hw)
    t_gemm = gemm_time(M, N, K, hw, dtype)
    if candidates is None:
        candidates = algorithms.candidates()
    candidates = _filter_by_budget(candidates, accuracy_budget, dtype)
    if eq8_is_memory_bound(M, N, K, hw, dtype):
        # Eq. 8 fast path: memory-bound GEMM => same-precision LCMA
        # cannot win. The quantized tier is exempt (see docstring).
        if not quantize:
            return Decision(M, N, K, dtype, None, t_gemm, None, ())
        ests: tuple[LCMAEstimate, ...] = ()
    else:
        ests = tuple(estimate(l, M, N, K, hw, dtype, fused=fused,
                              precombined_b=precombined_b)
                     for l in candidates)
    if quantize:
        ests += tuple(estimate_quant(l, M, N, K, hw, dtype, precombined_b=precombined_b)
                      for l in candidates if _quant_eligible(l, accuracy_budget))
    best = min(ests, key=lambda e: e.time, default=None)
    if best is not None and best.time * min_speedup < t_gemm:
        return Decision(M, N, K, dtype, best.lcma, t_gemm, best.time, ests,
                        precision=best.precision)
    return Decision(M, N, K, dtype, None, t_gemm, None, ests)


# ---------------------------------------------------------------------------
# Group-parallel batched pricing (paper §III-B Group-Parallel Optimizations)
#
# A grouped contraction is B independent (M, K) @ (K, N) products executed as
# ONE planned unit: per-element Combine A, Combine B either hoisted (shared
# operand) or per element, and a single (B*R)-batched intermediate GEMM.
# Pricing the group as a whole — instead of vmapping a per-element Decision —
# is what lets LCMA overhead amortize across the batch: the per-element
# problem may be memory-bound (Eq. 8 declines) while the grouped problem,
# with Combine-B hoisted and the R*B products batched, is not.
# ---------------------------------------------------------------------------

def gemm_time_batched(B: int, M: int, N: int, K: int,
                      hw: HardwareProfile | str, dtype: str = "bfloat16",
                      shared_b: bool = False) -> float:
    """Roofline time of the batched-GEMM baseline for a grouped contraction.

    ``shared_b`` models the broadcast-B baseline (one weight read for the
    whole group) so the LCMA-vs-GEMM comparison stays apples-to-apples.
    """
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    nb = 1 if shared_b else B
    flops = 2.0 * B * M * N * K
    mem = (B * (M * K + M * N) + nb * K * N) * by
    return max(flops / hw.flops_for(dtype), mem / hw.beta)


def batched_is_memory_bound(B: int, M: int, N: int, K: int,
                            hw: HardwareProfile | str,
                            dtype: str = "bfloat16",
                            shared_b: bool = False) -> bool:
    """Grouped Eq. 8 guard: a memory-bound batched GEMM admits no LCMA win."""
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    nb = 1 if shared_b else B
    ai = 2.0 * B * M * N * K / ((B * (M * K + M * N) + nb * K * N) * by)
    return ai <= hw.flops_for(dtype) / hw.beta


def estimate_grouped(l: LCMA, B: int, M: int, N: int, K: int,
                     hw: HardwareProfile | str, dtype: str = "bfloat16",
                     fused: bool = True, precombined_b: bool = False,
                     shared_b: bool = False) -> LCMAEstimate:
    """Per-stage cost of one grouped LCMA application (Table II, amortized).

    Relative to ``estimate``: Combine A and the output scale by B; Combine B
    scales by 1 when the B operand is shared across the group (hoisted — run
    once, reused B times) and by B otherwise; the GEMM stage is one
    (B*R)-batched product whose B-side traffic is likewise 1x or Bx. The
    ``padded_shape`` reported is the per-element one.

    The grouped GEMM stage also amortizes the *launch inefficiency* the
    autotuner measures: ``lcma_gemm_efficiency`` is calibrated on the
    R-batched stage (one group), and modelling its shortfall as a fixed
    per-launch overhead gives the B-group efficiency

        eff_B = B * eff / (B * eff + 1 - eff)

    — eff at B=1, approaching 1 as the R*B products fill the pipeline. This
    is why a grouped decision can pick an LCMA where pricing one group
    element (and vmapping) declines.
    """
    hw = _resolve_hw(hw)
    by = _dtype_bytes(dtype)
    m, k, n, R = l.m, l.k, l.n, l.R
    Mp, Kp, Np = _pad_up(M, m), _pad_up(K, k), _pad_up(N, n)
    Ms, Ks, Ns = Mp // m, Kp // k, Np // n
    nb = 1 if shared_b else B          # Combine-B / B-operand multiplicity
    Fa = hw.flops_add
    eff = hw.lcma_gemm_efficiency
    eff_b = B * eff / (B * eff + 1.0 - eff)
    Fx = hw.flops_for(dtype) * eff_b
    stages = []

    def stage(name, flops, nbytes, unit):
        stages.append(StageCost(name, flops, nbytes, flops / unit, nbytes / hw.beta))

    stage("combine_a", (l.nnz_u - R) * Ms * Ks * B,
          (Mp * Kp + R * Ms * Ks) * B * by, Fa)
    if not precombined_b:
        stage("combine_b", (l.nnz_v - R) * Ks * Ns * nb,
              (Kp * Np + R * Ks * Ns) * nb * by, Fa)
    gemm_flops = 2.0 * R * Ms * Ns * Ks * B
    if fused:
        stage("gemm+combine_h", gemm_flops,
              (B * R * Ms * Ks + nb * R * Ks * Ns + B * Mp * Np) * by, Fx)
    else:
        stage("gemm", gemm_flops,
              (B * R * Ms * Ks + nb * R * Ks * Ns) * by + B * R * Ms * Ns * H_BYTES, Fx)
        stage("combine_h", (l.nnz_w - m * n) * Ms * Ns * B,
              (Mp * Np * by + R * Ms * Ns * H_BYTES) * B, Fa)
    return LCMAEstimate(l, tuple(stages), (Mp, Np, Kp))


def decide_batched(B: int, M: int, N: int, K: int, hw: HardwareProfile | str,
                   dtype: str = "bfloat16",
                   candidates: list[LCMA] | None = None, fused: bool = True,
                   precombined_b: bool = False, shared_b: bool = False,
                   min_speedup: float = 1.0,
                   accuracy_budget: float | None = None,
                   quantize: bool = False) -> GroupedDecision:
    """Select the best LCMA for a grouped contraction, or batched GEMM.

    The grouped analogue of :func:`decide`: one Decision for the whole
    ``B x (M, K) @ (K, N)`` group. ``B=1`` degenerates to the 2-D model
    (same estimates as ``decide``). ``accuracy_budget`` filters candidates
    by static error bound exactly as in :func:`decide`; ``quantize=True``
    prices the int8 tier jointly (and bypasses the grouped Eq. 8 guard for
    it), exactly as in :func:`decide`.
    """
    hw = _resolve_hw(hw)
    t_gemm = gemm_time_batched(B, M, N, K, hw, dtype, shared_b=shared_b)
    if candidates is None:
        candidates = algorithms.candidates()
    candidates = _filter_by_budget(candidates, accuracy_budget, dtype)
    if batched_is_memory_bound(B, M, N, K, hw, dtype, shared_b=shared_b):
        if not quantize:
            return GroupedDecision(M, N, K, dtype, None, t_gemm, None, (),
                                   B=B, shared_b=shared_b)
        ests: tuple[LCMAEstimate, ...] = ()
    else:
        ests = tuple(estimate_grouped(l, B, M, N, K, hw, dtype, fused=fused,
                                      precombined_b=precombined_b, shared_b=shared_b)
                     for l in candidates)
    if quantize:
        ests += tuple(estimate_grouped_quant(l, B, M, N, K, hw, dtype,
                                             precombined_b=precombined_b,
                                             shared_b=shared_b)
                      for l in candidates if _quant_eligible(l, accuracy_budget))
    best = min(ests, key=lambda e: e.time, default=None)
    if best is not None and best.time * min_speedup < t_gemm:
        return GroupedDecision(M, N, K, dtype, best.lcma, t_gemm, best.time,
                               ests, precision=best.precision,
                               B=B, shared_b=shared_b)
    return GroupedDecision(M, N, K, dtype, None, t_gemm, None, ests,
                           B=B, shared_b=shared_b)
