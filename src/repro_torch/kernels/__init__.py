"""The hand-written CUDA kernels of the LCMA pipeline, the plain tiled GEMM,
and their wrappers.

A wrapper given CUDA tensors launches its kernel or raises. CPU tensors take
its plain version (``ref``), as do ``meta`` tensors, which carry shapes only
(the dry run traces the model on them): the plain version is exact in shape.
No CUDA tensor ever takes a plain version."""
from collections import Counter
from collections.abc import Mapping

from .fused_gemm import batched_fused_gemm_combine_h, fused_gemm_combine_h, tiled_matmul
from .group_combine import batched_group_combine, group_combine
from .ops import (falcon_grouped_matmul, falcon_grouped_matmul_precombined,
                  falcon_matmul, falcon_matmul_precombined, falcon_matmul_quant, matmul)
from .quant_combine import (fused_gemm_combine_h_quant, group_combine_quant,
                            quantize_b_blockwise)

# every kernel entry point; each carries its launch count as ``.launches``
KERNELS = (group_combine, batched_group_combine, fused_gemm_combine_h,
           batched_fused_gemm_combine_h, group_combine_quant,
           fused_gemm_combine_h_quant, tiled_matmul)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    tiled_matmul.routes = dict.fromkeys(tiled_matmul.routes, 0)
    group_combine_quant.routes = dict.fromkeys(group_combine_quant.routes, 0)
    group_combine.shapes.clear()
    batched_group_combine.shapes.clear()
    group_combine_quant.shapes.clear()
    fused_gemm_combine_h_quant.shapes.clear()
    fused_gemm_combine_h.shapes.clear()
    batched_fused_gemm_combine_h.shapes.clear()


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


_SUBCOUNTS = {"tiled_matmul": lambda: tiled_matmul.routes,
              "group_combine_quant": lambda: group_combine_quant.routes,
              "group_combine": lambda: group_combine.shapes,
              "batched_group_combine": lambda: batched_group_combine.shapes,
              "fused_gemm_combine_h": lambda: fused_gemm_combine_h.shapes,
              "batched_fused_gemm_combine_h": lambda: batched_fused_gemm_combine_h.shapes,
              "group_combine_quant/shape": lambda: group_combine_quant.shapes,
              "fused_gemm_combine_h_quant": lambda: fused_gemm_combine_h_quant.shapes}


def launch_state() -> Counter:
    """Every launch counter in one Counter: each kernel's launches under its
    name, and under ``(name, route or input shape)`` the tiled GEMM's and
    the quantizing Combine A's launches by route, Group Combine's (2-D and
    batched) by input shape, the fused kernel's (2-D and batched) by its
    operands' shapes, and the int8 kernels' by their operands' shapes and
    K-block (the quantizing Combine A's under ``"group_combine_quant/shape"``,
    its routes keeping its own name). ``launch_state() - before`` is what
    ran since ``before``."""
    state = Counter(launch_counts())
    for name, sub in _SUBCOUNTS.items():
        state.update({(name, k): n for k, n in sub().items()})
    return state


def add_launches(delta: Mapping, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a :func:`launch_state` difference) to
    the counters: what a CUDA graph replay launched without the wrappers."""
    by_name = {k.__name__: k for k in KERNELS}
    for key, n in delta.items():
        if isinstance(key, str):
            by_name[key].launches += sign * n
        else:
            name, sub = key
            _SUBCOUNTS[name]()[sub] += sign * n


__all__ = ["group_combine", "batched_group_combine", "fused_gemm_combine_h",
           "batched_fused_gemm_combine_h", "falcon_matmul",
           "falcon_matmul_precombined", "falcon_grouped_matmul",
           "falcon_grouped_matmul_precombined", "falcon_matmul_quant",
           "group_combine_quant", "fused_gemm_combine_h_quant",
           "quantize_b_blockwise", "tiled_matmul", "matmul", "KERNELS",
           "reset_launch_counts", "launch_counts", "launch_state", "add_launches"]
