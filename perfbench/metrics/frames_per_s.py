"""Env frames driven a second: envs x whole frames over the host time from
the window's first frame to a synchronize after its last."""

from perfbench import readers

UNIT = "frames/s"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return readers.rate(run)
