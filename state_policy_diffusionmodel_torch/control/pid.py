"""Functional PID controllers and ring-buffer filters, batched over B envs.

Counterpart of `state_policy_diffusionmodel_tpu/control/pid.py`, which is
written for one controller and vmapped. Here every field of `PIDState` and
`RingBuffer` carries a leading B axis; `PIDParams` fields are 0-dim (one
controller setting for all envs) or (B,) tensors, and broadcast.

simple-pid semantics, as in the JAX module: error = setpoint - input, the
integral accumulates Ki*e*dt, the derivative acts on the measurement, and
dt is the fixed sim tick 1/50 (the reference's wall-clock dt is not
deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..physics.car import const, div

F32 = torch.float32
DT = 1.0 / 50.0


class PIDParams(NamedTuple):
    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor
    setpoint: torch.Tensor


class PIDState(NamedTuple):
    integral: torch.Tensor      # (B,)
    last_input: torch.Tensor    # (B,)
    initialized: torch.Tensor   # (B,) bool


def pid_params(kp, ki, kd, setpoint=0.0, device="cuda") -> PIDParams:
    device = resolve_device(device)
    return PIDParams(*(torch.as_tensor(v, dtype=F32).to(device)
                       for v in (kp, ki, kd, setpoint)))


def pid_init(B: int, device="cuda") -> PIDState:
    device = resolve_device(device)
    z = torch.zeros((B,), dtype=F32, device=device)
    return PIDState(z, z, torch.zeros((B,), dtype=torch.bool, device=device))


def pid_update(p: PIDParams, s: PIDState, value: torch.Tensor,
               dt: float = DT):
    """(output (B,), new state) for measurements `value` (B,)."""
    value = value.to(F32)
    error = p.setpoint - value
    d_input = torch.where(s.initialized, value - s.last_input,
                          torch.zeros_like(value))
    integral = s.integral + p.ki * error * const(dt, value.device)
    derivative = div(-p.kd * d_input, dt)
    output = p.kp * error + integral + derivative
    return output, PIDState(integral, value, torch.ones_like(s.initialized))


class RingBuffer(NamedTuple):
    """Fixed-length moving-average buffers, zero-initialized (the
    reference's deques, generateParallelTraj.py:31-33)."""

    buf: torch.Tensor  # (B, N)


def ring_init(B: int, n: int, device="cuda") -> RingBuffer:
    return RingBuffer(torch.zeros((B, n), dtype=F32,
                                  device=resolve_device(device)))


def ring_push(r: RingBuffer, value: torch.Tensor) -> RingBuffer:
    """Drop the oldest entry, append `value` (B,) as the newest."""
    return RingBuffer(torch.cat([r.buf[:, 1:], value.to(F32)[:, None]], 1))


def ring_mean(r: RingBuffer) -> torch.Tensor:
    """(B,) mean rounded as XLA rounds `jnp.mean` of a short row: the
    entries summed oldest to newest, then multiplied by float32(1/N)."""
    acc = r.buf[:, 0]
    for i in range(1, r.buf.shape[1]):
        acc = acc + r.buf[:, i]
    return acc * const(1.0 / r.buf.shape[1], acc.device)
