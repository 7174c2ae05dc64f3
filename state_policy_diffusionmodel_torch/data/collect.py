"""Dataset generation on the device: a batch of envs driven by the PID
drivers, one episode per env.

Counterpart of `state_policy_diffusionmodel_tpu/data/collect.py`. The JAX
module scans chunks of steps under jit; here the steps are a Python loop
over the batched env (`envs.vector.step_batch` on a bank with one track per
env, `track_ids = arange(B)`), and each chunk's records move to the host in
one copy a key, so no step waits on the host.

Record alignment is the JAX package's (and the reference's): at step t an
episode stores the post-step observation frame with the pre-step position,
velocity and angle (those of the previous StepResult; the reset's for step
0) and the action applied. Frames are stored /255 as float32, actions
through `nan_to_num`; sinusoidal episodes also carry `h_action`, a copy of
the action; with `return_states`, `car_state` holds each step's post-step
`physics.save_state` vector.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import control, physics, resolve_device
from ..envs import vector
from ..physics.car import sqrt
from ..track import build as build_track, make_track, stack as stack_tracks
from ..track.geometry import TrackGeometry
from .replay_buffer import ReplayBuffer

DRIVERS = ("lane_follow", "center_follow", "sinusoidal")


def _speed(vel: torch.Tensor) -> torch.Tensor:
    """(B,) |v| of (B, 2) velocities."""
    return sqrt(vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1])


def collect_episodes(
    seeds,
    driver: str = "lane_follow",
    mode: str = "middle",
    target_velocity: float = 30.0,
    amplitude: float = 5.0,
    freq: float = 1.0 / 100.0,
    n_steps: int = 1000,
    chunk: int = 250,
    geoms: Optional[TrackGeometry] = None,
    progress: bool = False,
    return_states: bool = False,
    device="cuda",
) -> list[Dict[str, np.ndarray]]:
    """Run B = len(seeds) episodes at once, env b on track `seeds[b]` (or
    on track b of the bank `geoms`, which must hold B tracks on `device`).
    Returns one dict an episode in the reference dataset schema
    (img/velocity/position/action/angle)."""
    if driver not in DRIVERS:
        raise ValueError(f"driver {driver!r} is not one of {DRIVERS}")
    dev = resolve_device(device)
    B = len(seeds)
    if geoms is None:
        geoms = stack_tracks([build_track(make_track(int(s)), device=dev)
                              for s in seeds])
    if geoms.tex.shape[0] != B:
        raise ValueError(f"the bank holds {geoms.tex.shape[0]} tracks for "
                         f"{B} seeds")
    ids = torch.arange(B, dtype=torch.int32, device=dev)

    states, res = vector.reset_batch(geoms, track_ids=ids, device=dev)
    if driver == "lane_follow":
        params = control.lane_follow_params(mode, target_velocity, dev)
        ctrl = control.lane_follow_init(B, dev)

    keys = ["position", "velocity", "angle", "img", "action"]
    if return_states:
        keys.append("car_state")
    host = {k: [] for k in keys}
    pending = {k: [] for k in keys}

    def flush():
        for k in keys:
            # (B, n, ...): one device-to-host copy a key a chunk
            host[k].append(torch.stack(pending[k], 1).cpu().numpy())
            pending[k].clear()

    for i in range(n_steps):
        speed = _speed(res.info.car_velocity)
        if driver == "lane_follow":
            action, ctrl = control.lane_follow(params, ctrl, res.augmented,
                                               speed)
        elif driver == "center_follow":
            action = control.center_follow(res.obs, speed, target_velocity)
        else:
            action = control.sinusoidal(states.car, geoms, ids, float(i),
                                        amplitude, freq, target_velocity)
        pending["position"].append(res.info.car_position)
        pending["velocity"].append(res.info.car_velocity)
        pending["angle"].append(res.info.car_angle)
        states, res = vector.step_batch(states, geoms, action, track_ids=ids,
                                        device=dev)
        pending["img"].append(res.obs)
        pending["action"].append(action)
        if return_states:
            pending["car_state"].append(physics.save_state(states.car))
        if (i + 1) % chunk == 0 or i + 1 == n_steps:
            flush()
            if progress:
                print(f"  collected {i + 1}/{n_steps} steps x {B} envs")

    merged = {k: np.concatenate(v, 1) for k, v in host.items()}
    episodes = []
    for b in range(B):
        ep = {
            "img": merged["img"][b].astype(np.float32) / 255.0,
            "velocity": merged["velocity"][b].astype(np.float32),
            "position": merged["position"][b].astype(np.float32),
            "action": np.nan_to_num(merged["action"][b].astype(np.float32)),
            "angle": merged["angle"][b].astype(np.float32),
        }
        if driver == "sinusoidal":
            # the reference's sinusoidal datasets carry a "human action"
            # equal to the executed one (generateSinusoidalTraj.py:101,177)
            ep["h_action"] = ep["action"].copy()
        if return_states:
            ep["car_state"] = merged["car_state"][b].astype(np.float32)
        episodes.append(ep)
    return episodes


def generate_dataset(
    path: str,
    episodes_per_mode: int = 1,
    modes=("left", "right"),
    driver: str = "lane_follow",
    n_steps: int = 1000,
    target_velocity: float = 30.0,
    seed0: int = 43,
    make_zip: bool = False,
    save_states: bool = True,
    device="cuda",
    **kw,
) -> ReplayBuffer:
    """Episodes of every mode into one ReplayBuffer in the reference zarr
    schema, with `meta/track_seed` (one seed an episode, in buffer order)
    and, with save_states, the per-frame `data/car_state` vectors that let
    eval restore any frame in O(1); saved to `path` (blosc zstd-5 with
    bitshuffle, the JAX package's default) when given."""
    buffer = ReplayBuffer.create_empty_numpy()
    seed = seed0
    all_seeds = []
    for mode in modes:
        seeds = list(range(seed, seed + episodes_per_mode))
        seed += episodes_per_mode
        all_seeds.extend(seeds)
        for ep in collect_episodes(
            seeds, driver=driver, mode=mode, n_steps=n_steps,
            target_velocity=target_velocity, return_states=save_states,
            device=device, **kw,
        ):
            buffer.add_episode(ep)
    buffer.meta["track_seed"] = np.asarray(all_seeds, np.int64)
    if path:
        buffer.save_to_path(path, make_zip=make_zip)
    return buffer
