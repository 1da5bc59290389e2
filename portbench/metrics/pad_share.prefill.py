"""pad_share.prefill (%): of the rows the window's prefill steps launched,
the share that was padding (bucket rows x bucket length against the prompt
tokens the steps carried). Layer: engine and scheduler. Program counters
(ServeStats deltas per step)."""
from portbench.harness.readers import share_padded


def read(run):
    return share_padded(run, "prefill")
