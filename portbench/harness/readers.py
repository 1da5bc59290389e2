"""The arithmetic the metric files share (``portbench/metrics/<name>.py``
each call one of these with their own arguments). Every reader returns None
where its run has nothing for it to read."""
from __future__ import annotations

import re

from .work import Model, least_time, peaks_for, step_leaves

__all__ = ["share_padded", "lcma_share", "matmul_roofline", "mfu",
           "device_idle"]


def share_padded(run, kind: str) -> float | None:
    """Percent of the launched rows of ``kind`` steps that were padding."""
    real = padded = 0.0
    for s, w in run.weighted_steps(kind):
        real += s.real_tokens * w
        padded += s.padded_tokens * w
    return 100.0 * (padded - real) / padded if padded else None


def _ranks_to_blocks() -> dict:
    """Block products of the classical grid (m * k * n) of each rank in the
    port's scheme library."""
    from repro_torch.core import algorithms
    out = {}
    for scheme in algorithms.library().values():
        out.setdefault(scheme.R, set()).add(scheme.m * scheme.k * scheme.n)
    return {r: b.pop() for r, b in out.items() if len(b) == 1}


def lcma_share(run, kernels: tuple) -> float | None:
    """Percent of the window's projection operations, counted classically
    at the launched (bucket) rows, that the port's fused LCMA kernels ran:
    each launch of ``kernels`` counted from its operands' shapes
    ((R, X, Y) x (R, Y, Z): 2 * m*k*n * X*Y*Z), over all 2-D projections
    of the window's steps."""
    if run.launches is None:
        return None
    blocks = _ranks_to_blocks()
    lcma = 0.0
    for key, n in run.launches.items():
        if isinstance(key, tuple) and key[0] in kernels:
            (R, X, Y), (_, _, Z) = key[1][0], key[1][1]
            if R not in blocks:
                return None
            lcma += n * 2.0 * blocks[R] * X * Y * Z
    model = Model.from_config(run.config)
    per_row = sum(K * N for K, N in model.projections().values()) * model.layers
    # the LM head runs on one position of each of the bucket's rows
    total = sum(2.0 * (s.padded_tokens * per_row + s.batch * model.d * model.vocab)
                for s in run.steps)
    return 100.0 * lcma / total if total else None


def matmul_roofline(run, kind: str, patterns: str) -> float | None:
    """Percent: the least time of the product leaves of the traced ``kind``
    steps (``work.step_leaves``, each at its own bound) over the device
    time of the kernels whose names match ``patterns`` in those steps."""
    peaks = peaks_for(run.device.get("name", ""))
    if run.trace is None or peaks is None:
        return None
    traced = {op[3] for op in run.trace.ops if op[3] is not None}
    steps = [s for s in run.steps if s.kind == kind and s.index in traced]
    if not steps:
        return None
    match = re.compile(patterns, re.IGNORECASE).search
    kernel_s = sum(run.trace.op_seconds({s.index for s in steps}, match).values())
    if kernel_s <= 0:
        return None
    model = Model.from_config(run.config)
    bound = sum(leaf.least_s(peaks) for s in steps for leaf in step_leaves(model, s.rows))
    return 100.0 * bound / kernel_s


def mfu(run) -> float | None:
    """Percent: the window's work at its least time on the card
    (``work.least_time`` of each step, a straddling step in proportion)
    over the window's seconds."""
    peaks = peaks_for(run.device.get("name", ""))
    if peaks is None:
        return None
    model = Model.from_config(run.config)
    least = sum(least_time(model, s.rows, peaks) * w for s, w in run.weighted_steps())
    return 100.0 * least / run.seconds


def device_idle(run) -> float | None:
    """Percent of the traced window with no device operation running."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
