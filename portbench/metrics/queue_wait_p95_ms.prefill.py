"""queue_wait_p95_ms.prefill (ms): the 95th percentile of each request's
wait from submit to admission (the first prefill micro-batch that takes it:
the program's ``serve.queue`` spans), over requests admitted in the window.
Layer: engine and scheduler. Host clock, the program's spans."""
from portbench.harness.spans import queue_wait_ms


def read(run):
    return queue_wait_ms(run, 95)
