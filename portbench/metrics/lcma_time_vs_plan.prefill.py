"""lcma_time_vs_plan.prefill (%): the device seconds of the window's prefill
leaves (``falcon.leaf`` spans) whose path is an LCMA (a scheme, fp or int8),
over the sum of the seconds the Decision Module priced them at, each leaf
once a step: 100 where the price held. Read by laying each step's traced
operations over its graph's capture map (harness/spans.py); None where under
95% of the steps' device seconds were laid. Layer: Decision Module. Device
trace and the program's spans."""
from portbench.harness.spans import leaf_time_vs_plan


def read(run):
    return leaf_time_vs_plan(run, "prefill", lambda path: path not in (None, "gemm"))
