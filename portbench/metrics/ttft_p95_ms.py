"""ttft_p95_ms (ms): the 95th percentile of time to first token, from the
client's submit to the token's arrival, over every request whose first token
fell in the window. Host clock."""
from portbench.harness.record import tail


def read(run):
    t = tail(run.ttfts(), 95)
    return None if t is None else 1e3 * t
