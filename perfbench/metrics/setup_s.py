"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, weights, data, the warm-up."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return None if run.trace else run.setup_s
