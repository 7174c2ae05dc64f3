"""Model FLOPs of the untraced steps (forward and backward), each over the
peak of its unit, over the steps' CUDA-event time."""

from perfbench import readers

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "whole step"
MOVES = "samples_per_s"


def read(run):
    return readers.mfu(run, "step")
