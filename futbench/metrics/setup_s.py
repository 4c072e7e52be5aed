"""setup_s (s): from the start of the process (on several chips, of the
launching process) to the first call of the window: imports, the
kernels' build or load, the inputs and weights made from the seed, and
the warm-up calls."""


def read(run):
    return run.setup_s
