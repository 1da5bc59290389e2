"""matmul_roofline.prefill (%): the least time of every product of the traced
prefill steps (projections, LM head, attention's two products; work.step_leaves,
each at its own bound) over the device time of the kernels that implement
products in those steps, named by PATTERNS: cuBLAS's and CUTLASS's, and the
port's Group Combine, fused GEMM + Combine H, tiled GEMM and split reduce.
Layer: kernels. Device trace."""
from portbench.harness.readers import matmul_roofline

PATTERNS = (r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce|fused_tc_kernel|fused_f32"
            r"|group_combine|tiled_wgmma|f32_kernel|mma_kernel|split_reduce")


def read(run):
    return matmul_roofline(run, "prefill", PATTERNS)
