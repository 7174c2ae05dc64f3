"""Arithmetic shared by the metrics' readers (`metrics/<name>.py`).

Every reader returns None where its run has nothing to read, and the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import statistics
from typing import Optional

from . import trace


def rate(run) -> Optional[float]:
    """Work items a second over the host time of the window's whole
    units."""
    if run.trace or not run.units or not run.window_s:
        return None
    return run.units * run.unit_items / run.window_s


def p95(values) -> Optional[float]:
    """The 95th percentile, as `statistics.quantiles(n=20)` (inclusive)
    gives it."""
    values = list(values)
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def mean_spans(run, span: str, mark: Optional[str] = None,
               value: bool = True) -> Optional[float]:
    """Mean ms of the untraced units' `span`, of those whose `mark` is
    `value` when a mark is named."""
    if not run.trace:
        return None
    spans = run.untraced(span)
    if mark is not None:
        spans = [s for s, m in zip(spans, run.untraced_marks(mark))
                 if m == value]
    return statistics.fmean(spans) if spans else None


def idle_share(run) -> Optional[float]:
    """1 - the union of the device's spans over the traced window, in %."""
    p = run.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def roofline(run, op: str) -> Optional[float]:
    """The least time the chip could take for the work of `op`'s calls
    that its kernels took (operations over the peak of the unit they run
    on, or bytes over the memory's peak, the larger) over those kernels'
    traced time, in %. None where the calls and the kernels do not
    pair up one to one."""
    p = run.profile
    if p is None or not run.peaks:
        return None
    module = trace.roofline_ops()[op]
    calls = [c for c in p.calls.get(op, []) if module.takes(c)]
    kernels = p.kernels(op)
    if not calls or len(kernels) != len(calls) * module.KERNELS_A_CALL:
        return None
    least = 0.0
    for c in calls:
        flops, nbytes, unit = module.work(c)
        least += max(flops / run.peaks[unit],
                     nbytes / run.peaks["bytes_per_s"])
    took = sum(d for _, _, d in kernels) / 1e9
    return 100.0 * least / took if took > 0 else None


def mfu(run, unit_span: str) -> Optional[float]:
    """Model FLOPs of the untraced units, each over the peak of the unit
    that runs it (`run.precision`: convolutions and matmuls in fp32 or
    TF32), over the units' CUDA-event time, in %."""
    if not run.trace or run.flops is None or not run.peaks:
        return None
    spans = run.untraced(unit_span)
    if not spans:
        return None
    least = 0.0
    marks = run.untraced_marks("replan") if "replan" in run.marks else None
    for i in range(len(spans)):
        work = run.flops.unit(marks[i] if marks is not None else False)
        for kind, flops in work.items():
            least += flops / run.peaks[run.precision[kind]]
    return 100.0 * least / (sum(spans) / 1e3)
