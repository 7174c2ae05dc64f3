"""Training samples a second: B x whole optimizer steps over the host time
from the window's first step to a synchronize after its last."""

from perfbench import readers

UNIT = "samples/s"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return readers.rate(run)
