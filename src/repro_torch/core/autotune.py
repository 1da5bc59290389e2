"""Empirical autotuning: calibrate the Decision Module against the card.

The Decision Module (§III-C) prices candidates with an analytical roofline
``(FLOPS_x, FLOPS_+, beta)`` model; the ``h100_sxm`` profile carries the
data sheet's numbers, which the port's kernels do not reach. This module
measures the factors the model uses, on a few probe shapes, and fits a
calibrated :class:`HardwareProfile` that ``decision.decide`` takes in place
of the static one:

  * ``flops_mul`` — GEMM throughput, from timing ``kernels.ops.matmul``
    (the hand-written tiled GEMM) on the full probe;
  * ``beta`` — memory bandwidth, from timing a real Group Combine A (the
    memory-bound LCMA stage), not a synthetic stream;
  * ``flops_add`` — elementwise throughput at that bandwidth;
  * ``lcma_gemm_efficiency`` — the fused R-batched LCMA GEMM + Combine H
    stage relative to one big GEMM;
  * with ``quant=True``: ``flops_int8`` (``torch._int_mm``, the int8 product
    the reference leaves to XLA) into ``dtype_flops["int8"]``, and the
    quantizing Combine A's bandwidth ``beta_quant`` (metadata only).

Each probe is timed best-of-``reps`` after warm-up on the host clock, every
call bracketed by ``torch.cuda.synchronize()``: a calibration prices what a
call costs its caller. Fits take the median across probes, so one noisy
probe cannot skew the profile. The clock is injectable (``timer=``) so tests
calibrate deterministically; with ``device="cpu"`` the kernel wrappers run
their plain versions.

``python -m repro_torch.tools.tune`` is the CLI that writes the profile JSON
(with per-scheme block plans from ``kernels.tuning``) and warms the plan
cache.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import torch

from . import algorithms
from . import decision as dec
from .hardware import HardwareProfile, get_profile, register_profile, save_profile
from .lcma import LCMA

__all__ = ["ProbeMeasurement", "CalibrationReport", "autotune", "calibrate",
           "default_probe_shapes", "best_of_timer"]

# The served model's products on one H100: mlp_up and mlp_down of granite at
# the prefill M of 4 x 64 rows, and one large square operator. Smaller probes
# would time the launch, not the kernels.
_PROBE_SHAPES = [(256, 2048, 8192), (256, 8192, 2048), (4096, 4096, 4096)]


def _check_backend(backend: str) -> None:
    if backend != "cuda":
        raise ValueError(f"unknown autotune backend {backend!r} (the port has 'cuda')")


def default_probe_shapes(backend: str = "cuda") -> list[tuple[int, int, int]]:
    _check_backend(backend)
    return list(_PROBE_SHAPES)


def best_of_timer(reps: int = 3, warmup: int = 1, device="cuda") -> Callable:
    """Host-clock best-of timer; on a CUDA device each call is bracketed by
    ``torch.cuda.synchronize()``."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timer(fn, *args) -> float:
        for _ in range(warmup):
            fn(*args)
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn(*args)
            sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return timer


@dataclasses.dataclass(frozen=True)
class ProbeMeasurement:
    """One (M, K, N) probe: raw seconds + the per-probe derived quantities."""
    M: int
    K: int
    N: int
    dtype: str
    t_gemm: float                # the tiled GEMM on the full problem
    t_combine_a: float           # Group Combine A of the probe scheme
    t_batched: float             # fused R-batched LCMA GEMM + Combine H
    t_pipeline: float | None     # full LCMA pipeline (validation; may be skipped)
    flops_mul_est: float
    beta_est: float
    eff_est: float
    # int8 probes (``quant=True``): the int8 GEMM on the full problem and the
    # quantizing Combine A. None when the quant probe was skipped.
    t_gemm_int8: float | None = None
    t_quant_combine: float | None = None
    flops_int8_est: float | None = None
    beta_quant_est: float | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CalibrationReport:
    base: str
    backend: str
    dtype: str
    scheme: str
    probes: list[ProbeMeasurement]
    profile: HardwareProfile
    # per-probe relative error of the calibrated model's predicted LCMA
    # pipeline time vs the measured pipeline (empty when validation skipped)
    model_rel_err: list[float]
    # medians of the int8 probes (``quant=True``); flops_int8 is what lands
    # in the profile's dtype_flops["int8"], beta_quant rides in metadata
    flops_int8: float | None = None
    beta_quant: float | None = None

    @property
    def max_rel_err(self) -> float | None:
        return max(self.model_rel_err) if self.model_rel_err else None

    def metadata(self) -> dict:
        return {
            "base": self.base, "backend": self.backend, "dtype": self.dtype,
            "scheme": self.scheme,
            "probes": [p.as_dict() for p in self.probes],
            "model_rel_err": self.model_rel_err,
            "flops_int8": self.flops_int8,
            "beta_quant": self.beta_quant,
        }


def _combine_bytes(l: LCMA, Mp: int, Kp: int, itemsize: int) -> int:
    # Combine A moves M*K reads + R*(M/m)*(K/k) writes (Table II).
    return (Mp * Kp + l.R * (Mp // l.m) * (Kp // l.k)) * itemsize


def _int8_operands(M: int, K: int, N: int, device: torch.device):
    """int8 (M, K) and (K, N) ones for ``torch._int_mm``. On a card the
    product needs M > 16 and K, N multiples of 8 (and B column-major)."""
    if device.type == "cuda" and (M <= 16 or K % 8 or N % 8):
        raise ValueError(f"autotune quant probe ({M}, {K}, {N}): torch._int_mm on "
                         f"a CUDA device needs M > 16 and K, N multiples of 8")
    a8 = torch.ones((M, K), dtype=torch.int8, device=device)
    b8 = torch.ones((N, K), dtype=torch.int8, device=device).t()
    return a8, b8


def _measure_probe(M: int, K: int, N: int, l: LCMA, dtype: str, timer: Callable,
                   validate: bool, quant: bool, device: torch.device
                   ) -> ProbeMeasurement:
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gemm import fused_gemm_combine_h
    from repro_torch.kernels.group_combine import group_combine
    from repro_torch.kernels.quant_combine import group_combine_quant
    from repro_torch.kernels.tuning import scale_block
    from .falcon_gemm import _pad2

    tdt = getattr(torch, dtype)
    itemsize = torch.empty((), dtype=tdt).element_size()
    a = torch.ones((M, K), dtype=tdt, device=device)
    b = torch.ones((K, N), dtype=tdt, device=device)
    ap = _pad2(a, l.m, l.k).contiguous()
    bp = _pad2(b, l.k, l.n).contiguous()
    Mp, Kp = ap.shape
    X, Ks, Z = Mp // l.m, Kp // l.k, bp.shape[1] // l.n

    t_gemm = timer(ops.matmul, a, b)
    t_comb = timer(lambda x: group_combine(x, l.U), ap)
    at = group_combine(ap, l.U)
    bt = group_combine(bp, l.V)
    t_bat = timer(lambda x, y: fused_gemm_combine_h(x, y, l.W, out_dtype=tdt), at, bt)
    t_pipe = timer(lambda x, y: ops.falcon_matmul(x, y, l), a, b) if validate else None

    flops_mul = 2.0 * M * N * K / t_gemm
    beta = _combine_bytes(l, Mp, Kp, itemsize) / t_comb
    batched_flops = 2.0 * l.R * X * Ks * Z / t_bat
    eff = min(batched_flops / flops_mul, 1.0)
    t_g8 = t_qc = flops_int8 = beta_quant = None
    if quant:
        # FLOPS_int8: the int8 GEMM (int32 sums) on the full problem, the
        # rate the quantized tier's GEMM stage is priced with.
        t_g8 = timer(torch._int_mm, *_int8_operands(M, K, N, device))
        flops_int8 = 2.0 * M * N * K / t_g8
        # quant-pass beta: the fused Combine-A + blockwise-quantize kernel —
        # reads the fp operand, writes int8 Ã plus f32 block scales.
        by = scale_block(Ks)
        t_qc = timer(lambda x: group_combine_quant(x, l.U, by), ap)
        qbytes = Mp * Kp * itemsize + l.R * X * Ks + l.R * X * (Ks // by) * 4
        beta_quant = qbytes / t_qc
    return ProbeMeasurement(M, K, N, dtype, t_gemm, t_comb, t_bat, t_pipe,
                            flops_mul, beta, eff,
                            t_gemm_int8=t_g8, t_quant_combine=t_qc,
                            flops_int8_est=flops_int8, beta_quant_est=beta_quant)


def autotune(base: str | HardwareProfile = "h100_sxm", backend: str = "cuda",
             shapes: Sequence[tuple[int, int, int]] | None = None,
             dtype: str = "float32", scheme: str = "strassen",
             reps: int = 3, warmup: int = 1,
             timer: Callable | None = None, name: str | None = None,
             validate: bool = True, quant: bool = False,
             device="cuda") -> CalibrationReport:
    """Measure the backend on probe shapes and fit a calibrated profile.

    Returns a :class:`CalibrationReport`; ``report.profile`` is registered
    with ``hardware`` so ``FalconConfig(hardware=report.profile.name)`` and
    ``decide(..., hw=report.profile.name)`` resolve it at once.

    ``quant=True`` also measures the int8 stage — the int8 GEMM and the
    quantizing Combine A — and persists the measured FLOPS_int8 as the
    profile's ``dtype_flops["int8"]``. The profile fingerprint hashes
    ``dtype_flops``, so plan caches warmed under another calibration miss.
    """
    base_prof = get_profile(base) if isinstance(base, str) else base
    _check_backend(backend)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune: no CUDA device (pass device='cpu' to run the "
                           "kernels' plain versions)")
    shapes = list(shapes) if shapes is not None else default_probe_shapes(backend)
    timer = timer or best_of_timer(reps=reps, warmup=warmup, device=device)
    l = algorithms.get(scheme)

    with torch.inference_mode():
        probes = [_measure_probe(M, K, N, l, dtype, timer, validate, quant, device)
                  for (M, K, N) in shapes]

    flops_mul = statistics.median(p.flops_mul_est for p in probes)
    beta = statistics.median(p.beta_est for p in probes)
    eff = statistics.median(p.eff_est for p in probes)
    flops_add = beta / dec._dtype_bytes(dtype)  # 1 add/elem at effective BW

    flops_int8 = beta_quant = None
    if quant:
        flops_int8 = statistics.median(p.flops_int8_est for p in probes)
        beta_quant = statistics.median(p.beta_quant_est for p in probes)

    prof = dataclasses.replace(
        base_prof,
        name=name or f"{base_prof.name}_autotuned",
        flops_mul=flops_mul,
        flops_add=flops_add,
        beta=beta,
        lcma_gemm_efficiency=eff,
        # calibration is per measured dtype; the only per-dtype override a
        # calibrated profile carries is the measured int8 peak (quant=True)
        dtype_flops={"int8": flops_int8} if flops_int8 else None,
    )
    register_profile(prof)

    rel_err = []
    for p in probes:
        if p.t_pipeline is None:
            continue
        pred = dec.lcma_time(l, p.M, p.N, p.K, prof, dtype=dtype)
        rel_err.append(abs(pred - p.t_pipeline) / p.t_pipeline)

    return CalibrationReport(base=base_prof.name, backend=backend, dtype=dtype,
                             scheme=scheme, probes=probes, profile=prof,
                             model_rel_err=rel_err, flops_int8=flops_int8,
                             beta_quant=beta_quant)


def calibrate(path: str | None = None, block_plan_shapes: bool = True,
              **kw) -> tuple[CalibrationReport, str]:
    """``autotune`` + persist the profile JSON (the one-call convenience).

    The saved metadata embeds the probe measurements and, when requested,
    every candidate's Hopper block plans (``kernels.tuning.block_plans``) at
    a representative 4096^3 problem, the budget clamped to the profile's
    per-block shared memory — so a deploy host can inspect what the tuner saw.
    """
    report = autotune(**kw)
    meta = report.metadata()
    if block_plan_shapes:
        from repro_torch.kernels import tuning
        M, K, N = 4096, 4096, 4096
        meta["block_plans"] = {
            l.name: tuning.block_plans(l, M, K, N, dtype=report.dtype,
                                       hw=report.profile)
            for l in algorithms.candidates(max_grid=3)
        }
    out = save_profile(report.profile, path, metadata=meta)
    return report, out
