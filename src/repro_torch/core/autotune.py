"""Empirical autotuning: calibrate the Decision Module against the card.

The Decision Module (§III-C) prices candidates with an analytical roofline
``(FLOPS_x, FLOPS_+, beta)`` model; the ``h100_sxm`` profile carries the
data sheet's numbers, which the port's kernels do not reach. This module
measures the factors the model uses, on a few probe shapes, and fits a
calibrated :class:`HardwareProfile` that ``decision.decide`` takes in place
of the static one:

  * ``flops_mul`` — GEMM throughput, from timing the backend's GEMM on the
    full probe: ``kernels.ops.matmul`` (the hand-written tiled GEMM) on
    ``"cuda"``, ``torch.matmul`` on ``"torch"``;
  * ``beta`` — memory bandwidth, from timing a real Group Combine A (the
    memory-bound LCMA stage), not a synthetic stream;
  * ``flops_add`` — elementwise throughput at that bandwidth;
  * ``lcma_gemm_efficiency`` — the R-batched LCMA GEMM stage relative to
    one big GEMM: the fused kernel (GEMM + Combine H) on ``"cuda"``, the
    generated code's batched product on ``"torch"``;
  * on ``"torch"``, the grouped stage (``group_size`` groups of R products
    as one batched GEMM), checked against the eff_B law the grouped
    decisions assume (``decision.estimate_grouped``);
  * with ``collectives=True``: the process group's collective bandwidth
    (:func:`measure_collective_bw`) into ``collective_bw``, which the
    sharded decision tier divides collective bytes by;
  * with ``quant=True``: ``flops_int8`` (``torch._int_mm``, the int8 product
    the reference leaves to XLA) into ``dtype_flops["int8"]``, and the
    quantizing Combine A's bandwidth ``beta_quant`` (metadata only).

On a card each probe is timed on the device (:func:`device_timer`: CUDA
events around ``iters`` back-to-back calls, the median of ``reps``
readings), the kernels' own time wherever the host enqueues them faster
than the card runs them; on the CPU best-of-``reps`` on the host clock
(:func:`best_of_timer`, which on a card brackets every call by
``torch.cuda.synchronize()`` and so times the launches and the Python
around them as well: at granite's probe shapes a product takes ~0.014 ms
on the device). Fits take the median across probes, so one noisy probe
cannot skew the profile. The clock is injectable (``timer=``) so tests
calibrate deterministically, and the report names the clock that fitted
it (``CalibrationReport.clock``); with ``device="cpu"`` the kernel wrappers
run their plain versions.

``python -m repro_torch.tools.tune`` is the CLI that writes the profile JSON
(with per-scheme block plans from ``kernels.tuning``) and warms the plan
cache.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Callable, Sequence

import torch

from . import algorithms, codegen
from . import decision as dec
from .hardware import HardwareProfile, get_profile, register_profile, save_profile
from .lcma import LCMA

__all__ = ["ProbeMeasurement", "CalibrationReport", "autotune", "calibrate",
           "default_probe_shapes", "best_of_timer", "device_timer", "timer_clock",
           "measure_collective_bw"]

log = logging.getLogger(__name__)

# The served model's products on one H100: mlp_up and mlp_down of granite at
# the prefill M of 4 x 64 rows, and one large square operator. Smaller probes
# would time the launch, not the kernels.
_PROBE_SHAPES = [(256, 2048, 8192), (256, 8192, 2048), (4096, 4096, 4096)]


BACKENDS = ("cuda", "torch")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown autotune backend {backend!r} (the port has "
                         f"{' and '.join(map(repr, BACKENDS))})")


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

    timer.clock = "host"
    return timer


def device_timer(reps: int = 5, iters: int = 20, warmup: int = 1, device="cuda") -> Callable:
    """Device timer: CUDA events around ``iters`` back-to-back calls, the
    median of ``reps`` such readings, in seconds a call (``PERF.md``'s
    **E** readings). Where the host enqueues a call more slowly than the
    card runs it, the events time the host's rate instead."""
    device = torch.device(device)

    def timer(fn, *args) -> float:
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize(device)
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3 / iters)
        return statistics.median(ts)

    timer.clock = "device"
    return timer


def timer_clock(timer: Callable) -> str:
    """The clock a timer reads: ``"device"``, ``"host"``, or for an injected
    one its name."""
    return getattr(timer, "clock", None) or getattr(timer, "__name__", type(timer).__name__)


@dataclasses.dataclass(frozen=True)
class ProbeMeasurement:
    """One (M, K, N) probe: raw seconds + the per-probe derived quantities."""
    M: int
    K: int
    N: int
    dtype: str
    t_gemm: float                # the backend's GEMM on the full problem
    t_combine_a: float           # Group Combine A of the probe scheme
    t_batched: float             # the R-batched LCMA GEMM stage
    t_pipeline: float | None     # full LCMA pipeline (validation; may be skipped)
    flops_mul_est: float
    beta_est: float
    eff_est: float
    # (G*R)-batched grouped GEMM stage vs one big GEMM: validates the eff_B
    # law of ``decision.estimate_grouped``; None where the grouped probe is
    # skipped (group_size <= 1, or the "cuda" backend, whose grouped kernel
    # adds a grid dimension, not a bigger batched product)
    eff_grouped_est: float | None = None
    group_size: int = 1
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
    # measured (G*R)-batched grouped-stage efficiency (median over probes)
    # vs the eff_B law's prediction; None when the grouped probe was skipped
    eff_grouped: float | None = None
    eff_grouped_predicted: float | None = None
    # medians of the int8 probes (``quant=True``); flops_int8 is what lands
    # in the profile's dtype_flops["int8"], beta_quant rides in metadata
    flops_int8: float | None = None
    beta_quant: float | None = None
    # the collective probe (``collectives=True``): bytes/s over the process
    # group, its backend, and whether it went into the profile (not when
    # gloo ranks share a card: that times host staging, not a link)
    collective_bw: float | None = None
    collective_backend: str | None = None
    collective_recorded: bool = False
    # the clock that timed the probes (``timer_clock``)
    clock: str | None = None

    @property
    def max_rel_err(self) -> float | None:
        return max(self.model_rel_err) if self.model_rel_err else None

    def metadata(self) -> dict:
        return {
            "base": self.base, "backend": self.backend, "dtype": self.dtype,
            "scheme": self.scheme,
            "probes": [p.as_dict() for p in self.probes],
            "model_rel_err": self.model_rel_err,
            "eff_grouped": self.eff_grouped,
            "eff_grouped_predicted": self.eff_grouped_predicted,
            "flops_int8": self.flops_int8,
            "beta_quant": self.beta_quant,
            "collective_bw": self.collective_bw,
            "collective_backend": self.collective_backend,
            "collective_recorded": self.collective_recorded,
            "clock": self.clock,
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


def _measure_probe(M: int, K: int, N: int, l: LCMA, backend: str, dtype: str,
                   timer: Callable, validate: bool, quant: bool, device: torch.device,
                   group_size: int = 1) -> ProbeMeasurement:
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

    if backend == "cuda":
        t_gemm = timer(ops.matmul, a, b)
        t_comb = timer(lambda x: group_combine(x, l.U), ap)
        at = group_combine(ap, l.U)
        bt = group_combine(bp, l.V)
        t_bat = timer(lambda x, y: fused_gemm_combine_h(x, y, l.W, out_dtype=tdt), at, bt)
        t_pipe = timer(lambda x, y: ops.falcon_matmul(x, y, l), a, b) if validate else None
    else:
        # the generated code's own stages: Combine A, and the batched
        # product with H in f32, as the pipeline runs them
        gen = codegen.generate(l)
        gemm = gen.stages["gemm"]
        t_gemm = timer(torch.matmul, a, b)
        t_comb = timer(gen.combine_a, ap)
        at = torch.ones((l.R, X, Ks), dtype=tdt, device=device)
        bt = torch.ones((l.R, Ks, Z), dtype=tdt, device=device)
        t_bat = timer(gemm, at, bt)
        t_pipe = timer(gen.fn, ap, bp) if validate else None

    flops_mul = 2.0 * M * N * K / t_gemm
    beta = _combine_bytes(l, Mp, Kp, itemsize) / t_comb
    batched_flops = 2.0 * l.R * X * Ks * Z / t_bat
    eff = min(batched_flops / flops_mul, 1.0)
    eff_grouped = None
    if group_size > 1 and backend == "torch":
        # the group-parallel lowering: G groups of R products as ONE
        # (G*R)-batched GEMM, against the big GEMM
        G = int(group_size)
        ag = torch.ones((G * l.R, X, Ks), dtype=tdt, device=device)
        bg = torch.ones((G * l.R, Ks, Z), dtype=tdt, device=device)
        t_grp = timer(gemm, ag, bg)
        eff_grouped = min(2.0 * G * l.R * X * Ks * Z / t_grp / flops_mul, 1.0)
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
                            flops_mul, beta, eff, eff_grouped_est=eff_grouped,
                            group_size=int(group_size), t_gemm_int8=t_g8, t_quant_combine=t_qc,
                            flops_int8_est=flops_int8, beta_quant_est=beta_quant)


def measure_collective_bw(size_bytes: int = 8 << 20, reps: int = 3, warmup: int = 1,
                          timer: Callable | None = None) -> float | None:
    """Effective per-device collective bandwidth (bytes/s) over the process
    group of this process's mesh (``parallel.mesh.init_mesh``).

    Times a ring all-gather and a reduce-scatter of ``size_bytes`` of
    float32 over every rank and reports the slower of the two as
    bytes-moved-per-device / seconds: the number the sharded decision model
    divides collective bytes by. Tensors live on the mesh's device; on a
    gloo mesh of CUDA ranks they cross pinned host memory inside the timed
    call, as serving's collectives do. Returns ``None`` on a world of one
    (no mesh), where the profile's static ``link_bw`` remains the fallback.
    """
    import torch.distributed as dist

    from repro_torch.parallel.mesh import world_mesh

    mesh = world_mesh()
    if mesh is None or dist.get_world_size() < 2:
        return None
    D = dist.get_world_size()
    timer = timer or best_of_timer(reps=reps, warmup=warmup, device=mesh.device)
    n = max(size_bytes // 4 // D, 1)          # float32 elements per shard
    xl = torch.ones(n, dtype=torch.float32, device=mesh.device)
    x = torch.ones(D * n, dtype=torch.float32, device=mesh.device)

    def staged(fn):
        """``fn`` on pinned host copies where gloo takes no CUDA tensors."""
        if not mesh.staged:
            return fn
        return lambda t: fn(t.to("cpu").pin_memory()).to(mesh.device)

    def ag(t):
        out = torch.empty(D * n, dtype=t.dtype, device=t.device)
        dist.all_gather(list(out.view(D, n).unbind(0)), t)
        return out

    def rs(t):
        out = torch.empty(n, dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t)
        return out

    t_ag = timer(staged(ag), xl)
    t_rs = timer(staged(rs), x)
    moved = (D - 1) * n * 4                   # ring model: (D-1)/D of total
    return moved / max(t_ag, t_rs)


def autotune(base: str | HardwareProfile = "h100_sxm", backend: str = "cuda",
             shapes: Sequence[tuple[int, int, int]] | None = None,
             dtype: str = "float32", scheme: str = "strassen",
             reps: int = 3, warmup: int = 1,
             timer: Callable | None = None, name: str | None = None,
             validate: bool = True, group_size: int = 4, quant: bool = False,
             device="cuda", collectives: bool = False) -> CalibrationReport:
    """Measure the backend on probe shapes and fit a calibrated profile.

    Returns a :class:`CalibrationReport`; ``report.profile`` is registered
    with ``hardware`` so ``FalconConfig(hardware=report.profile.name)`` and
    ``decide(..., hw=report.profile.name)`` resolve it at once.

    ``backend`` is ``"cuda"`` (the hand-written kernels) or ``"torch"`` (the
    generated code around ``torch.matmul``/batched products); on
    ``"torch"`` the grouped stage of ``group_size`` groups is probed too.

    ``quant=True`` also measures the int8 stage — the int8 GEMM and the
    quantizing Combine A — and persists the measured FLOPS_int8 as the
    profile's ``dtype_flops["int8"]``. The profile fingerprint hashes
    ``dtype_flops``, so plan caches warmed under another calibration miss.

    ``collectives=True`` also probes the process group's collective
    bandwidth (:func:`measure_collective_bw`; None outside a mesh) and
    records it as the profile's ``collective_bw``, unless the mesh is gloo
    ranks sharing a card (staged through host memory): that figure is
    reported and left out of the profile.

    The default ``timer`` is :func:`device_timer` on a card and
    :func:`best_of_timer` on the CPU; ``report.clock`` names the one used.
    """
    base_prof = get_profile(base) if isinstance(base, str) else base
    _check_backend(backend)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune: no CUDA device (pass device='cpu' to run the "
                           "kernels' plain versions)")
    shapes = list(shapes) if shapes is not None else default_probe_shapes(backend)
    if timer is None:
        timer = (device_timer(reps=reps, warmup=warmup, device=device) if device.type == "cuda"
                 else best_of_timer(reps=reps, warmup=warmup, device=device))
    l = algorithms.get(scheme)

    with torch.inference_mode():
        probes = [_measure_probe(M, K, N, l, backend, dtype, timer, validate, quant,
                                 device, group_size=group_size)
                  for (M, K, N) in shapes]

    flops_mul = statistics.median(p.flops_mul_est for p in probes)
    beta = statistics.median(p.beta_est for p in probes)
    eff = statistics.median(p.eff_est for p in probes)
    flops_add = beta / dec._dtype_bytes(dtype)  # 1 add/elem at effective BW

    flops_int8 = beta_quant = None
    if quant:
        flops_int8 = statistics.median(p.flops_int8_est for p in probes)
        beta_quant = statistics.median(p.beta_quant_est for p in probes)

    coll_bw, coll_backend, recorded = base_prof.collective_bw, None, False
    measured = None
    if collectives:
        from repro_torch.parallel.mesh import world_mesh
        # host-synchronized collectives: timed on the host clock
        measured = measure_collective_bw(reps=reps, warmup=warmup)
        if measured is not None:
            mesh = world_mesh()
            coll_backend = mesh.backend
            if not mesh.staged:
                coll_bw, recorded = measured, True

    prof = dataclasses.replace(
        base_prof,
        name=name or f"{base_prof.name}_autotuned",
        flops_mul=flops_mul,
        flops_add=flops_add,
        beta=beta,
        lcma_gemm_efficiency=eff,
        collective_bw=coll_bw,
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

    # The grouped decisions' eff_B = G*eff/(G*eff + 1 - eff) should track
    # the measured (G*R)-batched efficiency; a large gap is worth a warning.
    eff_grouped = eff_grouped_pred = None
    grouped = [p for p in probes if p.eff_grouped_est is not None]
    if grouped:
        eff_grouped = statistics.median(p.eff_grouped_est for p in grouped)
        G = grouped[0].group_size
        eff_grouped_pred = G * eff / (G * eff + 1.0 - eff)
        if abs(eff_grouped - eff_grouped_pred) > 0.25:
            log.warning("autotune: grouped GEMM stage measured %.2f efficiency vs "
                        "eff_B model prediction %.2f (G=%d, eff=%.2f) - grouped "
                        "decisions may be mispriced on this backend",
                        eff_grouped, eff_grouped_pred, G, eff)

    return CalibrationReport(base=base_prof.name, backend=backend, dtype=dtype,
                             scheme=scheme, probes=probes, profile=prof,
                             model_rel_err=rel_err, eff_grouped=eff_grouped,
                             eff_grouped_predicted=eff_grouped_pred,
                             flops_int8=flops_int8, beta_quant=beta_quant,
                             collective_bw=measured, collective_backend=coll_backend,
                             collective_recorded=recorded, clock=timer_clock(timer))


def calibrate(path: str | None = None, block_plan_shapes: bool = True,
              host_clock: bool = False, **kw) -> tuple[CalibrationReport, str]:
    """``autotune`` + persist the profile JSON (the one-call convenience).

    The saved metadata embeds the probe measurements and, when requested,
    every candidate's Hopper block plans (``kernels.tuning.block_plans``) at
    a representative 4096^3 problem, the budget clamped to the profile's
    per-block shared memory — so a deploy host can inspect what the tuner saw.
    ``host_clock=True`` also fits the probes on :func:`best_of_timer` and
    records that fit beside the profile's (metadata ``host_clock``: its
    fitted numbers, ``model_rel_err`` and probes), registered as
    ``<name>_hostclock`` and not written: the profile is the first fit's.
    """
    report = autotune(**kw)
    meta = report.metadata()
    if host_clock:
        hkw = {k: v for k, v in kw.items() if k != "timer"}
        host = autotune(**{**hkw, "name": f"{report.profile.name}_hostclock",
                           "timer": best_of_timer(reps=kw.get("reps", 3),
                                                  warmup=kw.get("warmup", 1),
                                                  device=kw.get("device", "cuda"))})
        hp = host.profile
        meta["host_clock"] = {"clock": host.clock, "flops_mul": hp.flops_mul,
                              "flops_add": hp.flops_add, "beta": hp.beta,
                              "lcma_gemm_efficiency": hp.lcma_gemm_efficiency,
                              "model_rel_err": host.model_rel_err,
                              "flops_int8": host.flops_int8,
                              "probes": [p.as_dict() for p in host.probes]}
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
