"""The traced units: `torch.profiler` over the first units of the window,
and the calls into the operations that `rooflines/` names.

`Profile` keeps, of the profiler's events, the device's (kernels, copies,
sets: their name, start and duration) and the host's (aten operators and
the harness's own ranges), and the shapes of each roofline operation's
calls made while it ran. Busy time is the union of the device events'
spans, as `tools/profile_torch_policy.py::merged_ms` takes it (kernels
chained by programmatic dependent launch overlap).
"""

from __future__ import annotations

import glob
import importlib
import os
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOFLINES = os.path.join(HERE, "rooflines")


def merged(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of (start, end) spans as sorted disjoint spans."""
    out: List[List[int]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def roofline_ops(where: str = ROOFLINES) -> Dict[str, object]:
    """{operation: its module} for every `rooflines/<op>.py`."""
    from .harness import load_module

    return {os.path.splitext(os.path.basename(p))[0]:
            load_module(p, "perfbench_roofline_")
            for p in sorted(glob.glob(os.path.join(where, "*.py")))}


def kernel_names(op: str, where: str = ROOFLINES) -> List[str]:
    """The kernel names (substrings) of every `rooflines/<op>.*.names`."""
    names = []
    for path in sorted(glob.glob(os.path.join(where, f"{op}.*.names"))):
        with open(path) as f:
            names += [ln.strip() for ln in f
                      if ln.strip() and not ln.startswith("#")]
    return names


class _Recorder:
    """Replaces a program function by one that records its arguments'
    shapes (`op.describe`) and calls it."""

    def __init__(self, op_module):
        mod_name, attr = op_module.ENTRY.split(":")
        self.owner = importlib.import_module(mod_name)
        self.attr = attr
        self.inner = getattr(self.owner, attr)
        self.describe = op_module.describe
        self.calls: List[dict] = []

        def recording(*args, **kwargs):
            self.calls.append(self.describe(*args, **kwargs))
            return self.inner(*args, **kwargs)

        self.recording = recording

    def install(self):
        setattr(self.owner, self.attr, self.recording)

    def remove(self):
        setattr(self.owner, self.attr, self.inner)


class Profile:
    """What the profiler saw over the traced units."""

    def __init__(self):
        self.device: List[Tuple[str, int, int]] = []   # name, start, dur ns
        self.host: List[Tuple[str, int, int]] = []
        self.calls: Dict[str, List[dict]] = {}
        self.window_s = 0.0
        self.busy_s = 0.0
        self.gaps: List[Tuple[int, int]] = []

    # -- reading ------------------------------------------------------------
    def kernels(self, op: str) -> List[Tuple[str, int, int]]:
        names = kernel_names(op)
        return [e for e in self.device if any(n in e[0] for n in names)]

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for name, _, dur in self.device:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        by_host: Dict[str, float] = {}
        mids = [(a + b) // 2 for a, b in self.gaps]
        for (a, b), label in zip(self.gaps, self.host_at(mids)):
            by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e9
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}

    def host_at(self, times: List[int]) -> List[str]:
        """For each time, the innermost host range (an aten operator or the
        harness's own) that covers it: of the ranges open then, the one
        that began last."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        events = sorted(self.host, key=lambda e: e[1])
        out = ["host outside any operator"] * len(times)
        active: List[Tuple[str, int, int]] = []
        j = 0
        for i in order:
            t = times[i]
            while j < len(events) and events[j][1] <= t:
                active.append(events[j])
                j += 1
            active = [e for e in active if e[1] + e[2] >= t]
            if active:
                out[i] = max(active, key=lambda e: (e[1], -e[2]))[0]
        return out


class Tracer:
    """Starts the profiler and the call recorders before the first traced
    unit and stops them after `units` units (`at_unit` is called at every
    unit boundary of the window with the number of units done)."""

    def __init__(self, units: int, sync):
        self.units = units
        self.sync = sync
        self.prof = None
        self.recorders: Dict[str, _Recorder] = {}
        self.profile: Optional[Profile] = None
        self.t0 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        ops = roofline_ops()
        self.recorders = {op: _Recorder(m) for op, m in ops.items()}
        for r in self.recorders.values():
            r.install()
        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def at_unit(self, done: int) -> bool:
        """Stop once `done` traced units have run; True when stopped."""
        if self.prof is None or done < self.units:
            return False
        self.sync()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        for r in self.recorders.values():
            r.remove()
        self.profile = self._read(window_s)
        self.prof = None
        return True

    def _read(self, window_s: float) -> Profile:
        p = Profile()
        p.window_s = window_s
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            item = (e.name(), int(e.start_ns()), int(e.duration_ns()))
            if kind.endswith("CUDA"):
                # kernels, copies and sets; not the ranges that annotate
                # the device's timeline (`Optimizer.step#Adam.step`)
                if item[2] > 0 and not e.is_user_annotation():
                    p.device.append(item)
            elif not e.name().startswith("cuda"):
                p.host.append(item)
        spans = merged([(s, s + d) for _, s, d in p.device])
        p.busy_s = sum(b - a for a, b in spans) / 1e9
        p.gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
        p.calls = {op: r.calls for op, r in self.recorders.items()}
        return p
