"""The 95th percentile of every batched frame's time in the window (the time
between two calls of the policy, from CUDA events recorded at each call,
replanning frames included)."""

from perfbench import readers

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return None if run.trace else readers.p95(run.spans.get("frame", []))
