"""Execution backend registry for FalconGEMM dispatch.

The Decision Module picks *what* to run (an LCMA scheme or standard GEMM);
a **backend** decides *how* the chosen LCMA executes:

    from repro_torch.core.backends import register_backend

    def my_apply(a2, b, lcma, cfg):          # 2-D (M,K) @ (K,N) LCMA matmul
        ...
    register_backend("mine", my_apply)

The built-in ``"cuda"`` backend is the hand-written kernel pipeline
(``kernels.ops``). Its wrappers run the plain versions on CPU tensors, so
the same backend serves the tests.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

__all__ = ["Backend", "register_backend", "get_backend", "unregister_backend",
           "available_backends"]

# apply(a2, b, lcma, cfg) -> C : execute the LCMA matmul on 2-D operands.
ApplyFn = Callable
# apply_precombined(a2, bt, lcma, n_logical, cfg) -> C : execute against an
# offline-combined B̃ (R, K/k, N/n) — the PlannedWeight serving path.
ApplyPrecombinedFn = Callable
# apply_grouped(a3, b, lcma, cfg) -> C3 : a3 (G, M, K) against b (K, N)
# (shared; Combine B hoisted once) or (G, K, N) (per-group).
ApplyGroupedFn = Callable
# apply_grouped_precombined(a3, bt, lcma, n_logical, cfg) -> C3 : grouped
# serving path against precombined B̃ (R, K/k, N/n) or (G, R, K/k, N/n).
ApplyGroupedPrecombinedFn = Callable
# apply_quant(a2, bq, b_scales, lcma, n_logical, cfg) -> C : int8 serving
# path against offline-quantized B̃q (R, K/k, N/n) int8 + f32 block scales
# (the quantized PlannedWeight tier). None means the backend has no int8
# path and the quantized tier is not servable on it.
ApplyQuantFn = Callable


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered execution strategy."""

    name: str
    apply: ApplyFn
    apply_precombined: ApplyPrecombinedFn
    apply_grouped: ApplyGroupedFn
    apply_grouped_precombined: ApplyGroupedPrecombinedFn
    apply_quant: ApplyQuantFn | None = None
    description: str = ""


_REGISTRY: dict[str, Backend] = {}
_LOCK = threading.Lock()


def register_backend(name: str, impl, *,
                     apply_precombined: ApplyPrecombinedFn | None = None,
                     apply_grouped: ApplyGroupedFn | None = None,
                     apply_grouped_precombined: ApplyGroupedPrecombinedFn | None = None,
                     apply_quant: ApplyQuantFn | None = None,
                     description: str = "", overwrite: bool = False) -> Backend:
    """Register an execution backend under ``name``.

    ``impl`` is a callable ``(a2, b, lcma, cfg) -> C`` or a ready-made
    :class:`Backend`. A callable without the other fp entry points gets the
    built-in kernel pipeline's for them; ``apply_quant`` stays None unless
    given, so such a backend serves no int8 tier. Re-registering an existing
    name requires ``overwrite=True``.
    """
    if isinstance(impl, Backend):
        be = dataclasses.replace(impl, name=name)
    elif callable(impl):
        be = Backend(
            name=name, apply=impl,
            apply_precombined=apply_precombined or _cuda_apply_precombined,
            apply_grouped=apply_grouped or _cuda_apply_grouped,
            apply_grouped_precombined=(apply_grouped_precombined
                                       or _cuda_apply_grouped_precombined),
            apply_quant=apply_quant, description=description)
    else:
        raise TypeError(f"register_backend: impl must be callable or Backend, "
                        f"got {type(impl).__name__}")
    with _LOCK:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {name!r} already registered "
                             f"(pass overwrite=True to replace)")
        _REGISTRY[name] = be
    return be


def unregister_backend(name: str) -> None:
    """Remove a backend (tests / plugin teardown). Unknown names are no-ops."""
    with _LOCK:
        _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    be = _REGISTRY.get(name)
    if be is None:
        raise KeyError(f"unknown FalconGEMM backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)} (add one with register_backend)")
    return be


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# The built-in "cuda" backend. The kernel modules are imported at call time,
# so importing the registry never builds or loads a kernel.
# ---------------------------------------------------------------------------

def _cuda_apply(a2, b, l, cfg):
    from repro_torch.kernels import ops
    return ops.falcon_matmul(a2, b, l)


def _cuda_apply_precombined(a2, bt, l, n_logical, cfg):
    from repro_torch.kernels import ops
    return ops.falcon_matmul_precombined(a2, bt, l, n_logical)


def _cuda_apply_grouped(a3, b, l, cfg):
    from repro_torch.kernels import ops
    return ops.falcon_grouped_matmul(a3, b, l)


def _cuda_apply_grouped_precombined(a3, bt, l, n_logical, cfg):
    from repro_torch.kernels import ops
    return ops.falcon_grouped_matmul_precombined(a3, bt, l, n_logical)


def _cuda_apply_quant(a2, bq, b_scales, l, n_logical, cfg):
    from repro_torch.kernels import ops
    return ops.falcon_matmul_quant(a2, bq, b_scales, l, n_logical)


_REGISTRY["cuda"] = Backend(
    "cuda", _cuda_apply,
    apply_precombined=_cuda_apply_precombined,
    apply_grouped=_cuda_apply_grouped,
    apply_grouped_precombined=_cuda_apply_grouped_precombined,
    apply_quant=_cuda_apply_quant,
    description="hand-written CUDA kernel pipeline (plain versions on CPU)")
