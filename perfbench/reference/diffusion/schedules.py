"""The linear beta schedule, the forward process and the DDIM step,
PyTorch.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/schedules.py`.
The beta table is the same numpy array; the steps take tensors, with the
timestep `t` a Python int or an integer tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


def linear_betas(steps: int, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> np.ndarray:
    """diffusers 'linear' (DDPMScheduler defaults)."""
    return np.linspace(beta_start, beta_end, steps, dtype=np.float32)


SCHEDULES = {"linear": linear_betas}


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor           # (T,) f32
    alphas: torch.Tensor          # (T,)
    alphas_cumprod: torch.Tensor  # (T,)


def make_schedule(num_steps: int, kind: str = "linear",
                  device="cuda") -> DiffusionSchedule:
    betas = torch.from_numpy(SCHEDULES[kind](num_steps)).to(
        resolve_device(device))
    alphas = 1.0 - betas
    return DiffusionSchedule(betas, alphas, torch.cumprod(alphas, dim=0))


def _index(table: torch.Tensor, t) -> torch.Tensor:
    if isinstance(t, int):
        return table[t]
    return table[torch.as_tensor(t, device=table.device)]


def add_noise(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0). t: (B,) int, broadcast over x0 dims."""
    acp = _index(sched.alphas_cumprod, t)
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return (torch.sqrt(acp).reshape(shape) * x0
            + torch.sqrt(1.0 - acp).reshape(shape) * noise)


def _acp_prev(sched: DiffusionSchedule, prev_t: int) -> torch.Tensor:
    """alpha_bar at prev_t, with final_alpha_cumprod = 1 for prev_t < 0."""
    acp = sched.alphas_cumprod
    return acp[prev_t] if prev_t >= 0 else torch.ones_like(acp[0])


def ddim_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
              prev_t: int, x_t: torch.Tensor) -> torch.Tensor:
    """One reverse DDIM step, eta = 0, x0 clipped to [-1, 1]."""
    acp_t = _index(sched.alphas_cumprod, t)
    acp_p = _acp_prev(sched, prev_t)
    x0 = (x_t - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)
    x0 = torch.clamp(x0, -1.0, 1.0)
    return torch.sqrt(acp_p) * x0 + torch.sqrt(1.0 - acp_p) * eps


def ddim_timesteps(num_train: int, num_inference: int) -> np.ndarray:
    """The 'leading' DDIM grid (diffusers' default):
    (arange(n) * (train // n))[::-1]."""
    ratio = num_train // num_inference
    return (np.arange(num_inference) * ratio).round().astype(np.int64)[::-1].copy()
