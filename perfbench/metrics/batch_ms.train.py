"""Mean CUDA-event time of the trainer's batch fetch (windows gathered on the
card, t and the noise drawn) a step."""

from perfbench import readers

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "trainer data"
MOVES = "samples_per_s"


def read(run):
    return readers.mean_spans(run, "batch")
