"""The share of the traced window in which no device operation ran."""

from perfbench import readers

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "samples_per_s"


def read(run):
    return readers.idle_share(run)
