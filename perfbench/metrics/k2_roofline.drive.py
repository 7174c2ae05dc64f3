"""The texel gather's least time (bytes) at its traced calls' shapes over the
traced time of the kernels that did it (K2)."""

from perfbench import readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "frames_per_s"


def read(run):
    return readers.roofline(run, "texel_gather")
