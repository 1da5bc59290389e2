"""Three-term roofline analysis of one traced rank.

  compute term    = traced FLOPs / peak FLOP/s
  memory term     = traced bytes / HBM bw
  collective term = collective bytes / link bw

all per device. The reference reads these from a compiled XLA executable
(``cost_analysis``, ``memory_analysis`` and the HLO text's collectives); the
port has no HLO, so the dry run (``launch/dryrun.py``) traces one rank's step
on the ``meta`` device instead and this module turns what it counted into the
reference's :class:`RooflineReport`:

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode``;
  * bytes from :class:`BytesCounterMode`: every aten op's tensor operands
    and results (views excluded), the counterpart of XLA's "bytes accessed";
  * collective bytes by operation from the mesh's ``CollectiveStats.by_op``:
    each operation's result bytes, derived from its payload and group size
    n (an all-reduce's result is its payload, an all-gather's n times it, a
    reduce-scatter's 1/n), with the reference's traffic multipliers
    (all-reduce 2x for its reduce-scatter and all-gather ring phases, the
    others 1x). A backward's collectives (``<op>/bwd``) count under their
    operation.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hardware import H100_SXM, HardwareProfile

__all__ = ["RooflineReport", "BytesCounterMode", "collective_traffic", "analyze_traced"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# ring traffic per device relative to result bytes
_MULTIPLIER = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# the port's operation names (``parallel.collectives``) -> the reference's kinds
_KIND = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
         "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}

# a kind's result bytes over its payload, on a group of n ranks
_RESULT = {"all-reduce": lambda n: 1.0, "all-gather": lambda n: float(n),
           "reduce-scatter": lambda n: 1.0 / n}


class BytesCounterMode(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results while
    active (``.bytes``); view ops, which move nothing, are skipped. Works on
    ``meta`` tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            for t in _tensors((args, kwargs or {}, out)):
                self.bytes += t.numel() * t.element_size()
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def collective_traffic(stats) -> dict:
    """Per-kind collective traffic (bytes, multiplier applied) and counts
    from a mesh's ``CollectiveStats``."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for (op, ranks), (calls, payload, _, _) in stats.by_op.items():
        kind = _KIND[op.split("/")[0]]
        out[kind] += payload * _RESULT[kind](ranks) * _MULTIPLIER[kind]
        counts[kind] += calls
    out["_counts"] = counts
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # per device: the traced rank's FLOPs
    hlo_bytes: float              # per device: the traced rank's bytes
    coll_bytes: float             # per device
    coll_by_kind: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6ND / 2ND analytic, GLOBAL
    useful_ratio: float           # model_flops / (hlo_flops * chips)
    bytes_per_device: float       # the rank's argument bytes
    peak_flops: float
    notes: str = ""

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Achievable useful-FLOPs fraction of peak: how close the step is to
        the compute roofline, discounted by non-useful traced FLOPs."""
        if self.step_time <= 0:
            return 0.0
        return self.model_flops / self.chips / self.step_time / self.peak_flops

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["step_time"] = self.step_time
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze_traced(*, flops: float, bytes_accessed: float, stats, arch: str, shape: str,
                   mesh_name: str, chips: int, model_flops: float, bytes_per_device: float,
                   hw: HardwareProfile = H100_SXM, dtype: str = "bfloat16",
                   notes: str = "") -> RooflineReport:
    """The report of one traced rank: ``flops`` and ``bytes_accessed`` from
    the counters above, ``stats`` its mesh's ``CollectiveStats``."""
    coll = collective_traffic(stats)
    counts = coll.pop("_counts")
    total_coll = float(sum(coll.values()))
    peak = hw.flops_for(dtype)
    terms = {"compute": flops / peak, "memory": bytes_accessed / hw.beta,
             "collective": total_coll / hw.link_bw}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(flops), hlo_bytes=float(bytes_accessed), coll_bytes=total_coll,
        coll_by_kind={**coll, "counts": counts},
        t_compute=terms["compute"], t_memory=terms["memory"],
        t_collective=terms["collective"], bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        bytes_per_device=float(bytes_per_device), peak_flops=peak, notes=notes)
