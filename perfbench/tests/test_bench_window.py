"""The window's statistics: a stall lowers the rate and raises the tail;
a traced run reports no end-to-end number."""

import types

from perfbench import harness, readers


def window(frames_ms, extra_s=0.0):
    run = harness.Run("c", {}, {}, {}, 1, 1.0, False, "cpu")
    run.units, run.unit_items = len(frames_ms), 512
    run.window_s = sum(frames_ms) / 1e3 + extra_s
    run.spans["frame"] = list(frames_ms)
    return run


def test_stall_lowers_rate_and_raises_p95():
    base = [100.0 if k % 5 else 420.0 for k in range(300)]
    stalled = list(base)
    for k in range(3, 300, 10):                 # a 500 ms stall in 10%
        stalled[k] += 500.0
    a, b = window(base), window(stalled)
    assert readers.rate(b) < readers.rate(a)
    assert readers.p95(b.spans["frame"]) > readers.p95(a.spans["frame"])
    assert readers.rate(a) == 300 * 512 / (sum(base) / 1e3)


def test_p95_needs_twenty_and_is_inclusive():
    assert readers.p95(range(19)) is None
    assert readers.p95(range(1, 101)) == 95.05


def test_traced_run_reports_no_end_to_end():
    run = window([100.0] * 40)
    run.trace = True
    assert readers.rate(run) is None
    assert harness.reader("frame_ms_p95").read(run) is None
    assert harness.reader("setup_s").read(run) is None


def test_mean_spans_skip_the_traced_units():
    run = window([1000.0, 1000.0, 1000.0, 5.0, 7.0, 420.0])
    run.trace, run.traced_units = True, 2
    run.marks["replan"] = [True, False, False, False, False, True]
    assert readers.mean_spans(run, "frame", "replan", False) == 6.0
    assert readers.mean_spans(run, "frame", "replan", True) == 420.0
    assert readers.idle_share(types.SimpleNamespace(profile=None)) is None
