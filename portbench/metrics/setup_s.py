"""setup_s (s): from the process's start to a warmed engine: imports, the
kernels' build or load, the weights drawn on the card, the engine's
precombine, plans and graph captures. Host clock."""


def read(run):
    return run.setup_s
