"""The reference's data-generation drivers, batched over B envs.

Counterpart of `state_policy_diffusionmodel_tpu/control/drivers.py`, whose
functions act on one env and are vmapped. Here each takes (B, ...) tensors
and returns (B, 3) actions. Three controller families:

1. `lane_follow`: the parallel-lane follower. It scans row 60 of the
   augmented frame for the selected coloured lane, takes the lane pixel
   nearest col 48, cascades two moving-average filters, steers with a
   PID(0.8, 0.01, 0.06) and splits a velocity PID(0.005, 0.001, 0.0005)
   into gas or brake. An env whose strip shows no lane pixel repeats its
   last action and keeps its controller state.
2. `center_follow`: the strip-based centre follower, P control on the road
   middle of a grass-masked strip (the reference re-creates its PIDs every
   call, so they are pure P).
3. `sinusoidal`: the lane weaver; target = track middle + 10 px along the
   tangent + A*sin(2*pi*f*(t+1)) along the normal, from the analytic track
   geometry in the state image's pixel frame. Amplitude 5 is "safe", 13
   "unsafe".

The pixel decisions (lane column, found flag, grass edges) are integer
operations on uint8 frames and equal the JAX package's on the same frame;
the float outputs go through atan2, arctan and arccos, which may differ
from XLA's by an ulp.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..physics import CarState, hull_com_velocity
from ..physics.car import const, div, dot2, sqrt, table
from ..render import camera
from ..track.geometry import TrackGeometry, nearest_segment
from .pid import (
    PIDParams, PIDState, RingBuffer, pid_init, pid_params, pid_update,
    ring_init, ring_mean, ring_push,
)

F32 = torch.float32

# mode -> lane channel index (texture palette): lleft..rright = 1..5
MODES = ("lleft", "left", "middle", "right", "rright")

# RGB inRange bounds per mode (the reference's
# trajectory_control_utils.py:8-34), a copy of the JAX package's table
_LANE_BOUNDS = np.array([
    [[100, 100, 0], [255, 255, 0]],      # lleft  : yellow
    [[0, 100, 100], [0, 255, 255]],      # left   : cyan
    [[100, 0, 100], [255, 0, 255]],      # middle : magenta
    [[100, 0, 100], [200, 50, 200]],     # right  : purple
    [[0, 0, 100], [0, 0, 255]],          # rright : blue
], np.uint8)

STRIP_ROW = 60        # trajectory_control_utils.py:79
CAR_PX = (70.0, 48.0)  # (row, col) car pixel position


class LaneFollowState(NamedTuple):
    pid_steer: PIDState
    pid_vel: PIDState
    err_buf: RingBuffer       # (B, 10)
    err_buf2: RingBuffer      # (B, 3)
    vel_buf: RingBuffer       # (B, 7)
    last_action: torch.Tensor  # (B, 3) reused when the lane is not visible


class LaneFollowParams(NamedTuple):
    steer: PIDParams
    vel: PIDParams
    mode: int                 # lane index 0..4


def lane_follow_params(mode, target_velocity=30.0,
                       device="cuda") -> LaneFollowParams:
    """PID gains of generateParallelTraj.py:41-42; mode a name of MODES or
    its index."""
    if isinstance(mode, str):
        mode = MODES.index(mode)
    return LaneFollowParams(
        steer=pid_params(0.8, 0.01, 0.06, 0.0, device),
        vel=pid_params(0.005, 0.001, 0.0005, target_velocity, device),
        mode=int(mode))


def lane_follow_init(B: int, device="cuda") -> LaneFollowState:
    device = resolve_device(device)
    return LaneFollowState(
        pid_steer=pid_init(B, device), pid_vel=pid_init(B, device),
        err_buf=ring_init(B, 10, device), err_buf2=ring_init(B, 3, device),
        vel_buf=ring_init(B, 7, device),
        last_action=torch.zeros((B, 3), dtype=F32, device=device))


@functools.lru_cache(maxsize=None)
def _lane_bounds(mode: int, device: torch.device):
    """(lo, hi) (3,) uint8 RGB bounds of lane `mode` on `device`, copied
    there once: a copy from host memory waits for the device's queue."""
    return tuple(torch.from_numpy(_LANE_BOUNDS[mode, i]).to(device)
                 for i in range(2))


def _lane_mask_row(augm: torch.Tensor, mode: int) -> torch.Tensor:
    """(B, 96) bool: lane pixels on image row STRIP_ROW of (B, 96, 96, 3)
    uint8 frames."""
    row = augm[:, STRIP_ROW]                               # (B, 96, 3)
    lo, hi = _lane_bounds(mode, augm.device)
    return ((row >= lo) & (row <= hi)).all(-1)


def lane_column(augm: torch.Tensor, mode: int):
    """(column (B,) float32, found (B,) bool): the lane pixel on the strip
    nearest col 48, and whether there is one."""
    mask = _lane_mask_row(augm, mode)
    cols = torch.arange(96, dtype=F32, device=augm.device)
    dist = torch.where(mask, (cols - 48.0).abs(),
                       torch.full_like(cols, 1e9))
    # torch.argmin, like jnp.argmin, returns the first of equal minima: of
    # two lane pixels equally far from col 48, the left one
    return cols[torch.argmin(dist, dim=-1)], mask.any(-1)


def _freeze(found: torch.Tensor, new, old):
    """`new` where found, else `old`, leaf by leaf (env axis leading)."""
    if isinstance(new, tuple):
        return type(new)(*(_freeze(found, n, o) for n, o in zip(new, old)))
    f = found.reshape(found.shape + (1,) * (new.dim() - 1))
    return torch.where(f, new, old)


def lane_follow(params: LaneFollowParams, state: LaneFollowState,
                augm: torch.Tensor, speed: torch.Tensor):
    """One control tick for B envs. augm: (B, 96, 96, 3) uint8 augmented
    frames; speed: (B,) |v|. Returns (actions (B, 3), new state). An env
    whose strip shows no lane pixel repeats its previous action and keeps
    its whole state (generateParallelTraj.py:62-66)."""
    col, found = lane_column(augm, params.mode)

    err = (col - 48.0).clamp(-5.0, 5.0)
    err = torch.where(err.abs() <= 2.0, 0.3 * err, err)

    err_buf = ring_push(state.err_buf, err)
    err_avg = ring_mean(err_buf)
    err_buf2 = ring_push(state.err_buf2, err_avg)
    err_avg2 = ring_mean(err_buf2)

    # angle to the target: arctan2(|err|, |row distance|) with a sign flip
    # (trajectory_control_utils.py:58-62); the row distance is 10
    angle = torch.atan2(err_avg2.abs(), torch.full_like(err_avg2, 10.0))
    angle = torch.where(err_avg2 > 0, -angle, angle)
    steer, pid_steer = pid_update(params.steer, state.pid_steer, angle)

    speed = speed.to(F32)
    err_vel = params.vel.setpoint - speed
    err_vel = torch.where(err_vel.abs() < 2.0, torch.zeros_like(err_vel),
                          err_vel)
    vel_buf = ring_push(state.vel_buf, err_vel)
    err_vel_avg = ring_mean(vel_buf)
    vel_out, pid_vel = pid_update(params.vel, state.pid_vel, speed)
    slow_down = err_vel_avg < 0
    gas = torch.where(slow_down, torch.zeros_like(vel_out), vel_out)
    brake = torch.where(slow_down, vel_out.abs().clamp(0.0, 0.9),
                        torch.zeros_like(vel_out))

    action = torch.stack([steer, gas, brake], -1).to(F32)
    new_state = LaneFollowState(pid_steer, pid_vel, err_buf, err_buf2,
                                vel_buf, action)
    # freeze everything where the lane was not found
    out_state = _freeze(found, new_state, state)
    return _freeze(found, action, state.last_action), out_state


# ---------------------------------------------------------------------------
# strip-based centre follower (calculateAction, utils/functions.py:120-175)
# ---------------------------------------------------------------------------

def _grass_mask(img: torch.Tensor) -> torch.Tensor:
    """Grass pixels: the reference's HSV green mask reduces, on exact-palette
    frames, to 'green dominates red and blue by more than 30'."""
    img = img.to(torch.int32)
    return (img[..., 1] - torch.maximum(img[..., 0], img[..., 2])) > 30


def _edge_from_middle(line: torch.Tensor, direction: str) -> torch.Tensor:
    """(B,) first set column scanning out from col 48 of each (B, 96) line;
    -1 if none."""
    cols = torch.arange(96, device=line.device)
    if direction == "left":
        none = torch.full_like(cols, -1)
        return torch.where(line & (cols <= 48), cols, none).max(-1).values
    cand = torch.where(line & (cols >= 48), cols, torch.full_like(cols, 200))
    first = cand.min(-1).values
    return torch.where(first == 200, torch.full_like(first, -1), first)


def _middle_point(line: torch.Tensor) -> torch.Tensor:
    i1 = _edge_from_middle(line, "left")
    i2 = _edge_from_middle(line, "right")
    i1 = torch.where(i1 == -1, torch.zeros_like(i1), i1)
    i2 = torch.where(i2 == -1, torch.full_like(i2, 95), i2)
    return (i1 + i2) // 2          # integer floor division, both >= 0


def center_follow(obs: torch.Tensor, speed: torch.Tensor,
                  target_velocity=30.0) -> torch.Tensor:
    """calculateAction: P control on the strip's middle (fresh PIDs are pure
    P, functions.py:147-175). obs (B, 96, 96, 3) uint8, speed (B,).
    Returns (B, 3) actions."""
    grass = _grass_mask(obs)
    mid_u = _middle_point(grass[:, 55]).to(F32)   # strip rows 55..74
    angle_err = torch.atan(div(48.0 - mid_u, 20.0))
    control_ang = 0.5 * (0.0 - angle_err)          # PID(0.5, ...) fresh: P
    control_vel = 0.05 * (target_velocity - speed.to(F32))
    gas = control_vel.clamp(min=0.0)
    brake = (-control_vel).clamp(min=0.0)
    return torch.stack([control_ang.clamp(-1.0, 1.0), gas.clamp(0.0, 1.0),
                        brake.clamp(0.0, 1.0)], -1).to(F32)


# ---------------------------------------------------------------------------
# sinusoidal weaver (action_sinusoidalTrajectory, functions.py:177-209)
# ---------------------------------------------------------------------------

def _world_to_pixel(p, scroll, cam_angle):
    """World points -> (row, col) pixel coords of the state image."""
    w = camera.world_to_window(p, scroll, cam_angle)
    col = div(w[..., 0] * camera.STATE_W, camera.WINDOW_W)
    row = 95.5 - div(w[..., 1] * camera.STATE_H, camera.WINDOW_H)
    return torch.stack([row, col], -1)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """|v| of (B, 2) rows, the products summed left to right."""
    return sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])


def sinusoidal(car: CarState, bank: TrackGeometry, track_ids: torch.Tensor,
               t, amplitude=5.0, freq=1.0 / 100.0, target_velocity=30.0,
               scale_dist=10.0) -> torch.Tensor:
    """Sinusoidal trajectory actions (B, 3) from the analytic geometry of
    each env's track; t: the step index (a number or a (B,) tensor)."""
    dev = car.pos.device
    vel = hull_com_velocity(car)
    cam = camera.camera_angle(car.angle, vel)
    q = nearest_segment(bank, track_ids, car.pos[:, None])
    closest, tangent = q.closest[:, 0], q.tangent[:, 0]

    scroll, ang = car.pos, cam
    middle_px = _world_to_pixel(closest, scroll, ang)
    ahead_px = _world_to_pixel(closest + tangent, scroll, ang)
    tvec = ahead_px - middle_px
    tvec = tvec / _norm2(tvec).clamp(min=1e-9)[:, None]
    # point along the car's direction (up the image is (-1, 0) in
    # (row, col)): flip where the tangent points down
    tvec = torch.where((tvec[:, 0] > 0)[:, None], -tvec, tvec)
    perp = torch.stack([-tvec[:, 1], tvec[:, 0]], -1)

    # a number becomes a fill on the device, not a copy from the host
    t = t.to(F32) if torch.is_tensor(t) else const(t, dev)
    phase = (t + 1.0) * const(freq, dev) * 2.0 * const(np.pi, dev)
    sin_coeff = const(amplitude, dev) * torch.sin(phase)
    target = middle_px + tvec * scale_dist + sin_coeff[..., None] * perp

    err = target - table(CAR_PX, dev)
    denom = _norm2(err).clamp(min=1e-9)
    # err . (-1, 0), rounded as XLA's CPU dot rounds two terms
    dot = dot2(err[:, 0], -1.0, err[:, 1], 0.0)
    angle = torch.acos((dot / denom).clamp(-1.0, 1.0))
    angle = torch.where(err[:, 1] > 0, -angle, angle)

    steering = 0.5 * (0.0 - angle)          # fresh PID(0.5, -0.2, 0): P
    acc = 0.05 * (target_velocity - _norm2(vel))   # fresh PID(0.05, ...): P
    gas = acc.clamp(min=0.0)
    brake = (-acc).clamp(min=0.0)
    return torch.stack([steering, gas, brake], -1).to(F32)
