"""Mean CUDA-event time of the frames that do not replan: the env step with
its render and the encoder's push into the ring."""

from perfbench import readers

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "env and renderer"
MOVES = "frames_per_s"


def read(run):
    return readers.mean_spans(run, "frame", "replan", False)
