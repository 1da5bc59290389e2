"""launch_lag_ms.prefill (ms): the median host time from a prefill step's
entry into the engine (the program's ``serve.step`` span) to its launch
(``serve.launch``: the graph replay): scheduling and its inputs. Layer:
engine. Host clock, the program's spans."""
from portbench.harness.spans import launch_lag_ms


def read(run):
    return launch_lag_ms(run, "prefill")
