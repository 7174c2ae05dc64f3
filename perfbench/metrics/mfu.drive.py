"""Model FLOPs of the untraced frames (encoder every frame, the U-Net's
forwards every replan), each over the peak of its unit, over the frames'
CUDA-event time."""

from perfbench import readers

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "whole step"
MOVES = "frames_per_s"


def read(run):
    return readers.mfu(run, "frame")
