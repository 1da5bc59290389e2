"""Group Combine A/B (paper Alg. 2, stages 1-2): wrappers of the CUDA kernel.

Replaces the Pallas TPU kernels ``group_combine`` and
``batched_group_combine`` (``src/repro/kernels/group_combine.py``). One CUDA
kernel, ``csrc/group_combine.cu``, serves both: its grid carries the group
axis, with G = 1 for the 2-D form. It is bound by bytes on the H100: every
input element is read once and R outputs are written, (d1*d2 + R)*X*Y
elements against ~2 flops per coefficient term. So it is a stream of
16-byte accesses: a thread owns 16 bytes of consecutive y in a few rows,
reads its d1*d2 co-located vectors once (in place from the (d1*X, d2*Y)
input, no relayout) and writes each of the R outputs with one store, summed
in f32 over the scheme's coefficient table (staged in shared memory) and
rounded once. Where Y or a pointer rules out 16-byte loads (odd Y
included), the narrow route stages a block's rows of every part in shared
memory and still writes the contiguous output planes with 16-byte stores;
``tuning.plan_combine`` decides before the launch. Each wrapper counts its
launches by route (``.routes``: ``vector`` / ``narrow``) and the narrow
ones by input shape (``.narrow``).

A tensor on the CPU (or meta) takes the plain version (``ref.group_combine_ref``); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from . import build, ref
from .tuning import CombinePlan, plan_combine

__all__ = ["group_combine", "batched_group_combine", "coeff_table", "launch_plan",
           "refuse_grad"]

_TABLES: dict[tuple, torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()


def coeff_table(coeff: np.ndarray, device: torch.device) -> torch.Tensor:
    """The kernel's CSR coefficient table of ``coeff`` (R, d1, d2) on ``device``.

    int32, laid out ``row_ptr[R+1] | part[nnz] | coeff[nnz]``: rank r's
    nonzero terms with their flattened block index ``i*d2 + l``. Built once
    per coefficient tensor and device and cached; the key is the tensor's
    content, the part of ``LCMA.fingerprint`` it contributes.
    """
    coeff = np.asarray(coeff)
    key = (coeff.shape, coeff.tobytes(), str(device))
    tab = _TABLES.get(key)
    if tab is None:
        R = coeff.shape[0]
        flat = coeff.reshape(R, -1).astype(np.int64)
        rows, parts = np.nonzero(flat)              # row-major: r ascending
        row_ptr = np.searchsorted(rows, np.arange(R + 1))
        host = np.concatenate([row_ptr, parts, flat[rows, parts]]).astype(np.int32)
        tab = torch.as_tensor(host, device=device)
        with _TABLES_LOCK:
            tab = _TABLES.setdefault(key, tab)
    return tab


def refuse_grad(what: str, *ts: torch.Tensor) -> None:
    """Raise where autograd would record a kernel call: the kernels have no
    backward, so a gradient through one would silently be missing. Under
    grad, autograd reaches the kernels only through the planned cores of
    ``core.engine``, whose forward and backward run with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{what}: an operand requires grad and the kernels have no backward; "
            f"run under torch.no_grad(), or differentiate through the planned "
            f"cores (FalconConfig.planned_vjp=True, the default)")


def _check(x: torch.Tensor, coeff: np.ndarray, ndim: int, what: str):
    refuse_grad(what, x)
    if x.ndim != ndim:
        raise ValueError(f"{what}: expected a {ndim}-D input, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        f"(float32 and bfloat16 are)")
    R, d1, d2 = coeff.shape
    M, K = x.shape[-2:]
    if M % d1 or K % d2:
        raise ValueError(f"{what}: input {tuple(x.shape)} is not divisible by "
                         f"the coefficient grid ({d1}, {d2}) — pad first")
    if x.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous input")
    return R, d1, d2, M // d1, K // d2


def launch_plan(x: torch.Tensor, coeff: np.ndarray,
                out: torch.Tensor | None = None) -> CombinePlan:
    """The plan a wrapper launches for ``x`` (2-D, or 3-D with the group
    first) under ``coeff``: the vector route needs ``x`` and ``out`` (the
    output it writes, where given; a fresh allocation) 16-byte aligned."""
    R, d1, d2 = coeff.shape
    aligned = x.data_ptr() % 16 == 0 and (out is None or out.data_ptr() % 16 == 0)
    return plan_combine(x.shape[0] if x.ndim == 3 else 1, x.shape[-2] // d1,
                        x.shape[-1] // d2, coeff, x.element_size(), aligned)


def _launch(x3: torch.Tensor, coeff: np.ndarray, R, d1, d2, X, Y) -> tuple[torch.Tensor, str]:
    G = x3.shape[0]
    out = torch.empty((G, R, X, Y), dtype=x3.dtype, device=x3.device)
    tab = coeff_table(coeff, x3.device)
    plan = launch_plan(x3, coeff, out)
    lib = build.library("group_combine")
    args = (x3.device.index, x3.data_ptr(), out.data_ptr(), tab.data_ptr(), tab.numel(),
            build.DTYPE_CODES[str(x3.dtype).removeprefix("torch.")], G, R, d1, d2, X, Y)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    if plan.route == "vector":
        err = lib.falcon_group_combine(*args, plan.vec, plan.ty, plan.tx, plan.rows,
                                       plan.smem_bytes, stream)
    else:
        err = lib.falcon_group_combine_narrow(*args, plan.xb, plan.yb, plan.threads,
                                              plan.smem_bytes, stream)
    build.check(lib, err, f"group_combine ({plan.route})")
    return out, plan.route


def _count(fn, shape: tuple, route: str) -> None:
    fn.launches += 1
    fn.shapes[shape] += 1
    fn.routes[route] += 1
    if route == "narrow":
        fn.narrow[shape] += 1


def group_combine(x: torch.Tensor, coeff: np.ndarray) -> torch.Tensor:
    """Group Combine of ``x`` (d1*X, d2*Y) -> (R, X, Y).

    ``coeff`` is U (R, m, k) for Combine A (x = A) or V (R, k, n) for Combine
    B (x = B). Dimensions must divide exactly; padding is the caller's
    (``repro_torch.kernels.ops``).
    """
    R, d1, d2, X, Y = _check(x, coeff, 2, "group_combine")
    if x.device.type != "cuda":
        return ref.group_combine_ref(ref.split_blocks(x, d1, d2), coeff)
    out, route = _launch(x[None], coeff, R, d1, d2, X, Y)
    _count(group_combine, tuple(x.shape), route)
    return out[0]


def batched_group_combine(x: torch.Tensor, coeff: np.ndarray) -> torch.Tensor:
    """Group Combine over a group: (G, d1*X, d2*Y) -> (G, R, X, Y)."""
    R, d1, d2, X, Y = _check(x, coeff, 3, "batched_group_combine")
    if x.device.type != "cuda":
        return ref.group_combine_ref(ref.split_blocks(x, d1, d2), coeff)
    out, route = _launch(x, coeff, R, d1, d2, X, Y)
    _count(batched_group_combine, tuple(x.shape), route)
    return out


for _fn in (group_combine, batched_group_combine):
    _fn.launches = 0                             # kernel launches, counted by the wrapper
    _fn.shapes = Counter()                       # the same launches by input shape
    _fn.routes = {"vector": 0, "narrow": 0}      # ... by route
    _fn.narrow = Counter()                       # the narrow route's, by input shape
