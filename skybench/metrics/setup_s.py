"""From the process's start to the measured window: imports, the card's
context, the kernels' build or load, the window pool and the warm window."""


def read(run):
    return run.setup_s
