"""device_idle.prefill (%): the share of the traced window with no kernel, copy or
set running on the card. Layer: device. Device trace."""
from portbench.harness.readers import device_idle


def read(run):
    return device_idle(run)
