"""The hand-written CUDA kernels of the LCMA pipeline, the plain tiled GEMM,
and their wrappers."""
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
    group_combine.shapes.clear()


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["group_combine", "batched_group_combine", "fused_gemm_combine_h",
           "batched_fused_gemm_combine_h", "falcon_matmul",
           "falcon_matmul_precombined", "falcon_grouped_matmul",
           "falcon_grouped_matmul_precombined", "falcon_matmul_quant",
           "group_combine_quant", "fused_gemm_combine_h_quant",
           "quantize_b_blockwise", "tiled_matmul", "matmul", "KERNELS",
           "reset_launch_counts", "launch_counts"]
