"""mfu.prefill (%): the window's model work at its least time on the card (each
step's products at the 49/64 floor, attention at its real context, each
byte once: work.least_time) over the window's seconds, against the H100
SXM data sheet's peaks. Layer: model step. Host clock and shapes."""
from portbench.harness.readers import mfu


def read(run):
    return mfu(run)
