"""Tracing and timing utilities.

Counterpart of `state_policy_diffusionmodel_tpu/utils/profiling.py`:

- `trace(log_dir)`: a `torch.profiler` context over the host (CPU) and,
  where there is a card, the device (CUDA) that writes one Chrome trace
  (`trace_<pid>_<ms>.json`, readable in Perfetto or chrome://tracing) into
  `log_dir` when the block ends. The JAX version writes a jax.profiler
  trace for TensorBoard's profile tab. On the card the port's own kernels,
  launched through ctypes, appear under their CUDA symbol names
  (`attention_core_kernel...`, `conv3x3_...`);
- `StepTimer`: throughput counters (steps/s, items/s) with jsonl-friendly
  snapshots;
- `timed`: a `with` block that reports host wall time for a named phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace into log_dir. Usage:
    `with profiling.trace('/tmp/trace') as prof: step()`; after the block
    `prof.trace_path` names the file."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(prof.trace_path)


class StepTimer:
    """Throughput counter: call `tick(n_items)` once per step."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.items = 0

    def tick(self, n_items: int = 1):
        self.steps += 1
        self.items += n_items

    def snapshot(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "seconds": dt,
            "steps": self.steps,
            "steps_per_sec": self.steps / dt,
            "items_per_sec": self.items / dt,
        }

    def reset(self):
        self.__init__()


class timed:
    """`with timed('phase') as t: ...` — then `t.seconds`."""

    def __init__(self, name: str, log=None):
        self.name = name
        self.log = log
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.log is not None:
            self.log({"event": "timing", "name": self.name,
                      "seconds": self.seconds})
        return False
