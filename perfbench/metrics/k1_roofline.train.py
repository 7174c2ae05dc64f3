"""Attention's least time at its traced forward calls' shapes over the traced
time of the kernels that did it (K1)."""

from perfbench import readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "samples_per_s"


def read(run):
    return readers.roofline(run, "attention")
