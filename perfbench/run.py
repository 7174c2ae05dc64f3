"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload r5blend.drive --seed 7 \
        --seconds 30 --trace 0

Everything a cell needs is found by name: the cell in `BENCHMARK.json`
(its configuration and traffic), `perfbench/workloads/<cell>.json` (the
traffic's parameters and the generator that reads them),
`perfbench/configs/<config>.json` (the sizes and the run directory),
`perfbench/metrics/<metric>.py` (each metric's reader) and
`perfbench/rooflines/` (each operation's work and its kernels' names).
`perfbench/harness.py` says what a run does.
"""

import os
import sys
import time

PROCESS_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], PROCESS_START))
