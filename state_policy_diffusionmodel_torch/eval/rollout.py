"""Closed-loop action replay in the env, the eval suite's workhorse.

Counterpart of `state_policy_diffusionmodel_tpu/eval/rollout.py`. The
reference eval scripts re-execute predicted actions in a deterministically
seeded env: reset on a fixed track, replay the dataset's actions to the
window start, then execute the candidate actions, held for `step_size`
frames (precision) or interpolated linearly between the sparse actions
(consistency).

The JAX module scans one env and vmaps over N candidates. Here a replay is
a Python loop over the batched env with `render=False` (no frames, so no
K2 launch, as in the JAX replay), and `replay_batch` steps N copies of the
start state at once on a one-track bank. Trajectories are batch-first:
(B, n_steps, ...).
"""

from __future__ import annotations

import torch

from ..envs import car_racing as env
from ..physics.car import div
from ..track.geometry import TrackGeometry


def interpolate_actions(sparse: torch.Tensor, step_size: int) -> torch.Tensor:
    """(..., T, 3) sparse actions -> (..., (T-1)*step_size, 3) per-frame
    actions by linear interpolation (eval_consistency_diffusion_actions.py:
    27-29)."""
    T = sparse.shape[-2]
    t = div(torch.arange((T - 1) * step_size, dtype=torch.float32,
                         device=sparse.device), float(step_size))
    lo = torch.floor(t).to(torch.int64)
    w = (t - lo)[:, None]
    return sparse[..., lo, :] * (1 - w) + sparse[..., lo + 1, :] * w


def hold_actions(sparse: torch.Tensor, step_size: int) -> torch.Tensor:
    """Zero-order hold: each of (..., T, 3) actions for step_size frames
    (eval_precision.py:127-137)."""
    return torch.repeat_interleave(sparse, step_size, dim=-2)


def _track_ids(state: env.EnvState) -> torch.Tensor:
    """Every env on track 0 of a one-track bank."""
    return torch.zeros(state.reward.shape[0], dtype=torch.int32,
                       device=state.reward.device)


@torch.no_grad()
def replay(geom: TrackGeometry, state: env.EnvState, actions: torch.Tensor,
           n_steps: int):
    """Execute per-frame actions (B, >= n_steps, 3) from the B envs of
    `state`, all on the one-track bank `geom`. Returns (final state,
    positions (B, n_steps, 2), (velocities (B, n_steps, 2), rewards
    (B, n_steps)))."""
    ids = _track_ids(state)
    pos, vel, rew = [], [], []
    for k in range(n_steps):
        state, res = env.step(state, geom, ids, actions[:, k], render=False)
        pos.append(res.info.car_position)
        vel.append(res.info.car_velocity)
        rew.append(res.reward)
    return (state, torch.stack(pos, 1),
            (torch.stack(vel, 1), torch.stack(rew, 1)))


def state_at_window_start(geom: TrackGeometry, dataset_actions,
                          n_warmup_frames: int) -> env.EnvState:
    """One env reset on the one-track bank `geom`, then the dataset's own
    actions (n, 3) replayed for `n_warmup_frames` dense frames (the
    reference's warm-up loop, eval_consistency_diffusion_actions.py:168-171:
    through the end of the observation span, since the predicted actions
    follow it)."""
    dev = geom.tex.device
    state, _ = env.reset(geom, torch.zeros(1, dtype=torch.int32, device=dev),
                         render=False)
    if n_warmup_frames > 0:
        acts = torch.as_tensor(dataset_actions[:n_warmup_frames],
                               dtype=torch.float32).to(dev)
        state, _, _ = replay(geom, state, acts[None], int(n_warmup_frames))
    return state


def replay_batch(geom: TrackGeometry, state: env.EnvState,
                 action_batch: torch.Tensor, n_steps: int):
    """Replay N candidate action sequences (N, T, 3) from the one env of
    `state`: one batched env of N copies of it, on track 0."""
    N = action_batch.shape[0]
    copies = type(state)(
        type(state.car)(*(f.expand((N,) + f.shape[1:]).clone()
                          for f in state.car)),
        *(f.expand((N,) + f.shape[1:]).clone() for f in state[1:]))
    return replay(geom, copies, action_batch, n_steps)
