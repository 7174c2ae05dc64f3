"""The traffic generators: each reads its parameters from a workload file
and drives the port through its normal entry points. What both share:
the device clock and the configuration's check."""

from __future__ import annotations

import time

import torch

from ..harness import Refused


class Clock:
    """CUDA events on the card (host time on the CPU, for the tests)."""

    def __init__(self, device: torch.device):
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def ms(a, b) -> float:
        if isinstance(a, float):
            return (b - a) * 1e3
        return a.elapsed_time(b)


def config_matches(policy_config, config: dict):
    """The program's policy config against the configuration file."""
    got = {k: getattr(policy_config, k) for k in config["policy"]}
    if got != config["policy"]:
        raise Refused(f"the program's policy config {got} is not the "
                      f"configuration's {config['policy']}")
