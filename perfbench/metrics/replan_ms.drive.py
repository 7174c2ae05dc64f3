"""Mean CUDA-event time of the frames that replan (DDIM at B = envs, then the
frame's env step)."""

from perfbench import readers

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sampler"
MOVES = "frame_ms_p95"


def read(run):
    return readers.mean_spans(run, "frame", "replan", True)
