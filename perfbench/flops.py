"""Model FLOPs of one unit of a cell's work, counted on the reference.

`torch.utils.flop_counter.FlopCounterMode` over the reference's nets at a
batch of one on the CPU, scaled by the unit's batch (every counted
operation is linear in the batch), as `cli/mfu.py::count_flops` counts the
port's plain path. The counter sees convolutions and matrix products
(attention's included) and no elementwise work. Each count is split by
the unit it runs on: convolutions (cuDNN) and matrix products.

A drive frame encodes `envs` frames; a replanning frame adds
`inference_steps` U-Net forwards at B = envs. A training step is the
loss's forward and backward at B = batch (a frozen encoder forward
only).
"""

from __future__ import annotations

from typing import Dict

import torch


def _split(counter) -> Dict[str, float]:
    out = {"conv": 0.0, "matmul": 0.0}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out["conv" if "conv" in str(op) else "matmul"] += float(n)
    return out


def _scaled(d: Dict[str, float], k: float) -> Dict[str, float]:
    return {u: v * k for u, v in d.items()}


def _add(a, b):
    return {u: a[u] + b[u] for u in a}


class Counts:
    def __init__(self, plain: Dict[str, float], extra: Dict[str, float]):
        self.plain, self.extra = plain, extra

    def unit(self, marked: bool) -> Dict[str, float]:
        """One unit's FLOPs by kind; `marked` adds the replan's."""
        return _add(self.plain, self.extra) if marked else self.plain


def unit_counts(config: dict, traffic: dict) -> Counts:
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.checkpoints import policy_config
    from .reference.diffusion import DiffusionPolicy

    torch.manual_seed(0)
    policy = DiffusionPolicy(policy_config(config["policy"]), "cpu")
    cfg = policy.config
    params = policy.modules()
    H = cfg.obs_horizon
    if traffic["generator"] == "drive":
        envs = int(traffic["envs"])
        with torch.no_grad():
            c = FlopCounterMode(display=False)
            with c:
                policy.encode_images(params, torch.zeros((1, 1, 96, 96, 3)))
            enc = _split(c)
            c = FlopCounterMode(display=False)
            with c:
                params["unet"](torch.zeros((1, cfg.horizon,
                                            cfg.prediction_dim, 1)),
                               torch.zeros((1,), dtype=torch.int64),
                               torch.zeros((1, H * cfg.observation_dim)))
            unet = _split(c)
        return Counts(_scaled(enc, envs),
                      _scaled(unet, envs * int(traffic["inference_steps"])))
    T = cfg.obs_horizon + cfg.pred_horizon
    batch = {"position": torch.zeros((1, T, 2)),
             "action": torch.zeros((1, T, 3)),
             "velocity": torch.zeros((1, T, 2)),
             "image": torch.zeros((1, H, 96, 96, 3))}
    c = FlopCounterMode(display=False)
    with c:
        loss = policy.loss(params, batch,
                           t=torch.zeros((1,), dtype=torch.int64),
                           noise=torch.zeros((1, cfg.horizon,
                                              cfg.prediction_dim)))
        loss.backward()
    step = _split(c)
    return Counts(_scaled(step, int(traffic["batch"])),
                  {"conv": 0.0, "matmul": 0.0})
