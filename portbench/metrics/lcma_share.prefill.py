"""lcma_share.prefill (%): of the window's projection operations, counted
classically at the rows each step launched, the share the port's fused LCMA
kernels ran: the launches of the fused GEMM + Combine H (fp and int8) by
operand shape, from the program's launch counters (graph replays counted).
Layer: the Decision Module, which chose them."""
from portbench.harness.readers import lcma_share

KERNELS = ("fused_gemm_combine_h", "fused_gemm_combine_h_quant")


def read(run):
    return lcma_share(run, KERNELS)
