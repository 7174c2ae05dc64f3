"""Beta schedules and closed-form diffusion math, PyTorch.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/schedules.py`.
The beta tables are the same numpy arrays; the steps take tensors, with the
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


def linear_betas_v2(steps: int) -> np.ndarray:
    """Linear betas scaled by 500/steps."""
    scale = 500 / steps
    return np.linspace(scale * 1e-4, scale * 0.02, steps, dtype=np.float32)


def cosine_betas(steps: int, s: float = 0.008) -> np.ndarray:
    """squaredcos_cap_v2."""
    n = steps + 1
    x = np.linspace(0, n, n)
    ac = np.cos(((x / n) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999).astype(np.float32)


SCHEDULES = {
    "linear": linear_betas,
    "linear_v2": linear_betas_v2,
    "cosine": cosine_betas,
    "squaredcos_cap_v2": cosine_betas,
}


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


def _acp_prev(sched: DiffusionSchedule, prev_t) -> torch.Tensor:
    """alpha_bar at prev_t, with final_alpha_cumprod = 1 for prev_t < 0."""
    acp = sched.alphas_cumprod
    if isinstance(prev_t, int):
        return acp[prev_t] if prev_t >= 0 else torch.ones_like(acp[0])
    prev_t = torch.as_tensor(prev_t, device=acp.device)
    return torch.where(prev_t >= 0, acp[prev_t.clamp_min(0)],
                       torch.ones((), dtype=acp.dtype, device=acp.device))


def ddpm_step(sched: DiffusionSchedule, eps: torch.Tensor, t,
              x_t: torch.Tensor, z: torch.Tensor,
              clip_sample: bool = False) -> torch.Tensor:
    """One reverse DDPM step (epsilon prediction, variance 'fixed_small');
    z is standard normal and ignored at t == 0."""
    beta_t = _index(sched.betas, t)
    alpha_t = _index(sched.alphas, t)
    acp_t = _index(sched.alphas_cumprod, t)
    acp_p = _acp_prev(sched, t - 1)

    x0 = (x_t - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    coef0 = torch.sqrt(acp_p) * beta_t / (1.0 - acp_t)
    coef_t = torch.sqrt(alpha_t) * (1.0 - acp_p) / (1.0 - acp_t)
    mean = coef0 * x0 + coef_t * x_t

    var = torch.clamp(beta_t * (1.0 - acp_p) / (1.0 - acp_t), min=1e-20)
    sigma = torch.where(torch.as_tensor(t, device=var.device) > 0,
                        torch.sqrt(var), torch.zeros_like(var))
    return mean + sigma * z


def ddim_step(sched: DiffusionSchedule, eps: torch.Tensor, t, prev_t,
              x_t: torch.Tensor, clip_sample: bool = True) -> torch.Tensor:
    """One reverse DDIM step, eta = 0, clip_sample=True by default."""
    acp_t = _index(sched.alphas_cumprod, t)
    acp_p = _acp_prev(sched, prev_t)
    x0 = (x_t - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    return torch.sqrt(acp_p) * x0 + torch.sqrt(1.0 - acp_p) * eps


def dpmpp_2m_step(sched: DiffusionSchedule, eps: torch.Tensor, t, prev_t,
                  x_t: torch.Tensor, m_prev: torch.Tensor,
                  lam_prev: torch.Tensor, second_order: bool,
                  clip_sample: bool = True, x0_fix=None):
    """One DPM-Solver++(2M) multistep update (data-prediction form).

    m_prev, lam_prev: the previous step's x0 prediction and log-SNR.
    second_order: False on the first step (no history) and on the last
    (lower-order final). x0_fix: an optional function applied to the x0
    prediction after the clip (x0-space inpainting; the JAX package keeps
    it for models trained without the input constraint, and its sampler
    overwrites x_t instead). Returns (x_next, m0, lam_s)."""
    acp_s = _index(sched.alphas_cumprod, t)
    acp_p = _acp_prev(sched, prev_t)
    alpha_s, sigma_s = torch.sqrt(acp_s), torch.sqrt(1.0 - acp_s)
    alpha_p = torch.sqrt(acp_p)
    # at prev_t < 0 sigma_p would be 0: clamp so lambda stays finite and
    # exp(-h) underflows to the exact x -> x0 limit
    sigma_p = torch.sqrt(torch.clamp(1.0 - acp_p, min=1e-30))

    m0 = (x_t - sigma_s * eps) / alpha_s
    if clip_sample:
        m0 = torch.clamp(m0, -1.0, 1.0)
    if x0_fix is not None:
        m0 = x0_fix(m0)

    lam_s = torch.log(alpha_s / sigma_s)
    lam_p = torch.log(alpha_p / sigma_p)
    h = lam_p - lam_s
    h0 = lam_s - lam_prev
    d1 = (m0 - m_prev) / (h0 / h)
    # select, don't scale: without history d1 may be inf/nan
    if not second_order:
        d1 = torch.zeros_like(d1)
    em1 = torch.exp(-h) - 1.0
    x_next = (sigma_p / sigma_s) * x_t - alpha_p * em1 * (m0 + 0.5 * d1)
    return x_next, m0, lam_s


def ddim_timesteps(num_train: int, num_inference: int,
                   spacing: str = "leading") -> np.ndarray:
    """DDIM timestep grids: 'leading' (diffusers default,
    (arange(n) * (train // n))[::-1]) or 'trailing'
    (arange(train, 0, -train/n).round() - 1)."""
    if spacing == "trailing":
        return (np.round(np.arange(num_train, 0, -num_train / num_inference))
                .astype(np.int64) - 1).copy()
    ratio = num_train // num_inference
    return (np.arange(num_inference) * ratio).round().astype(np.int64)[::-1].copy()
