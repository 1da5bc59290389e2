"""Hardware abstraction for the Decision Module and the kernel tile planner.

The paper abstracts a platform as ``(FLOPS_x, FLOPS_+, beta)`` (§III-C):
  * ``FLOPS_x`` — matrix-multiply throughput (Tensor Cores),
  * ``FLOPS_+`` — elementwise add/sub throughput (CUDA cores),
  * ``beta``    — off-chip (HBM) bandwidth for the target dtype.

We extend it with the interconnect rates the sharded decision tier prices
collectives with (``link_bw``, ``collective_bw``) and the memory and on-chip
capacities the tile planner needs (``vmem_bytes`` is the per-block
shared-memory budget on a GPU; the field keeps the reference package's name
so profiles round-trip).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

__all__ = ["HardwareProfile", "H100_SXM", "CPU_HOST", "get_profile",
           "register_profile", "profile_dir", "profile_path",
           "save_profile", "load_profile", "ENV_PROFILE_DIR", "calibrate_cpu"]


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops_mul: float            # FLOPS_x  (per chip, matmul units, bf16 unless noted)
    flops_add: float            # FLOPS_+  (per chip, vector units)
    beta: float                 # HBM bytes/s per chip
    link_bw: float = 50e9       # interconnect bytes/s per link per chip
    hbm_bytes: int = 16 << 30
    vmem_bytes: int = 16 << 20  # on-chip working-set budget of one kernel block
    mxu_align: int = 128        # matrix-unit tile alignment
    dtype_flops: dict | None = None  # per-dtype FLOPS_x override
    # throughput of the R-batched LCMA GEMM relative to one big GEMM
    # (1.0 = no batching loss; measured by an autotuner)
    lcma_gemm_efficiency: float = 1.0
    # effective per-device collective (all-gather / reduce-scatter) bytes/s,
    # measured by the autotuner's collective probe; 0.0 => not measured,
    # fall back to the static per-link rate.
    collective_bw: float = 0.0

    def flops_for(self, dtype: str) -> float:
        if self.dtype_flops and dtype in self.dtype_flops:
            return self.dtype_flops[dtype]
        return self.flops_mul

    def coll_bw(self) -> float:
        """Collective bandwidth for the sharded decision model: the measured
        value when the collective probe ran, else the profiled link rate."""
        return self.collective_bw if self.collective_bw > 0 else self.link_bw

    @property
    def ridge_intensity(self) -> float:
        """FLOPS_x / beta — the roofline ridge point (FLOP per byte)."""
        return self.flops_mul / self.beta

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareProfile":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


# NVIDIA H100 SXM, data sheet, uncalibrated (dense rates at the 700 W limit).
# Tensor cores: 989 TFLOP/s bf16, 1979 TOP/s int8; float32 runs on the CUDA
# cores at 67 TFLOP/s (TF32 stays off), which is also FLOPS_+ for the combines.
# 80 GB HBM3 at 3.35 TB/s; 232,448 B of shared
# memory per block; wgmma tiles are 64 rows. NVLink 4: 18 links x 25 GB/s
# per direction = 450 GB/s (data sheet, uncalibrated); ``collective_bw``
# stays 0.0 (not measured). ``repro_torch.tools.tune``
# measures the card and registers the calibrated ``h100_sxm_autotuned``.
H100_SXM = HardwareProfile(
    name="h100_sxm",
    flops_mul=989e12,
    flops_add=67e12,
    beta=3.35e12,
    link_bw=450e9,
    hbm_bytes=80 * 10**9,
    vmem_bytes=232_448,
    mxu_align=64,
    dtype_flops={"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12},
)

# A CPU host — rough defaults, used by CPU-side runs and tests.
CPU_HOST = HardwareProfile(
    name="cpu_host",
    flops_mul=6.0e10,
    flops_add=1.5e10,
    beta=2.0e10,
    link_bw=1e9,
    hbm_bytes=32 << 30,
    vmem_bytes=32 << 20,   # L2/L3 analogue
    mxu_align=8,
    dtype_flops=None,
)

_PROFILES = {p.name: p for p in (H100_SXM, CPU_HOST)}

# Calibrated profiles live here; set the env var to relocate. Looked up
# lazily by ``get_profile``.
ENV_PROFILE_DIR = "FALCON_PROFILE_DIR"


def profile_dir() -> str:
    return os.environ.get(ENV_PROFILE_DIR) or os.path.join(
        os.path.expanduser("~"), ".cache", "falcon_gemm", "profiles")


def profile_path(name: str) -> str:
    return os.path.join(profile_dir(), f"{name}.json")


def register_profile(p: HardwareProfile) -> HardwareProfile:
    """Make a profile resolvable by name (``FalconConfig.hardware``)."""
    _PROFILES[p.name] = p
    return p


def save_profile(p: HardwareProfile, path: str | None = None,
                 metadata: dict | None = None) -> str:
    """Write a profile (plus optional calibration metadata) as JSON."""
    path = path or profile_path(p.name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    doc = p.to_dict()
    if metadata:
        doc["_metadata"] = metadata
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def load_profile(path: str, register: bool = True) -> HardwareProfile:
    with open(path) as f:
        doc = json.load(f)
    p = HardwareProfile.from_dict(doc)
    if register:
        register_profile(p)
    return p


def get_profile(name: str) -> HardwareProfile:
    """Resolve a profile by name: built-ins/registered first, then the
    on-disk calibrated-profile directory."""
    p = _PROFILES.get(name)
    if p is not None:
        return p
    path = profile_path(name)
    if os.path.exists(path):
        return load_profile(path)
    raise KeyError(f"unknown hardware profile {name!r} "
                   f"(no built-in and no {path})")


_CPU_CAL_CACHE: dict = {}


def calibrate_cpu(size: int = 1024, dtype="float32") -> HardwareProfile:
    """Measure the host's (FLOPS_x, FLOPS_+, beta) for decisions made on
    the CPU, and register the result as ``cpu_host_calibrated``.

    It times ``torch.matmul`` at ``size`` cubed, a real Group Combine A of
    Strassen through the generated ``"torch"`` backend
    (``codegen.generate(...).combine_a``) and the 7-batched product at
    ``size / 2``, on the host's CPU tensors, and fits the reference's
    formulas: ``flops_mul`` from the product, ``beta`` from the combine's
    bytes (M·K reads and R·(M/2)·(K/2) writes) over its time, ``flops_add``
    as one add per element at that rate, ``lcma_gemm_efficiency`` as the
    batched product's rate over the single one's (at most 1). Measuring
    the host is this function's purpose, so unlike the port's entry points
    it does not default to the card. Cached on ``(size, dtype)``.
    """
    key = (size, str(dtype))
    if key in _CPU_CAL_CACHE:
        return _CPU_CAL_CACHE[key]
    import torch
    from repro_torch.core import algorithms as _alg, codegen as _cg

    dt = getattr(torch, str(dtype))
    a = torch.ones((size, size), dtype=dt)
    b = torch.ones((size, size), dtype=dt)
    comb = _cg.generate(_alg.get("strassen")).combine_a

    def best(f, *args, reps=3):
        f(*args)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f(*args)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    with torch.inference_mode():
        t_mm = best(torch.matmul, a, b)
        t_comb = best(comb, a)
        h = size // 2
        t_bmm = best(torch.bmm, torch.ones((7, h, h), dtype=dt), torch.ones((7, h, h), dtype=dt))
    flops_mul = 2 * size**3 / t_mm
    # batched-GEMM efficiency: the LCMA GEMM stage is an R-batched matmul
    eff = min(2 * 7 * h**3 / t_bmm / flops_mul, 1.0)
    itemsize = a.element_size()
    # Combine A moves M·K reads + R·(M/2)·(K/2) writes at the effective rate
    beta = (size * size + 7 * h * h) * itemsize / t_comb
    prof = dataclasses.replace(
        CPU_HOST, flops_mul=flops_mul, flops_add=beta / itemsize, beta=beta,
        lcma_gemm_efficiency=eff, name="cpu_host_calibrated")
    _CPU_CAL_CACHE[key] = prof
    _PROFILES[prof.name] = prof  # resolvable via FalconConfig.hardware
    return prof
