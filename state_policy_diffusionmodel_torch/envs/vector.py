"""Batched env over a track bank, and rollouts as Python loops.

Counterpart of `state_policy_diffusionmodel_tpu/envs/vector.py`. The JAX
module vmaps the per-env functions and scans the rollouts; here the env
functions are batched already (`car_racing.py`), every env's track is
`track_ids[b]` in a bank, and the rollouts are loops that keep only the
actions, the rewards and their sums unless the caller asks for the
trajectory (256 envs x 1500 frames of two uint8 frames would be 21 GB).

Entry points take `device=` and default to "cuda"; the bank must lie on
that device. The sharded rollouts split the envs over the ranks of a
`parallel.Mesh` (one process a rank): each rank runs the loop above on its
contiguous block of envs, with no collective inside the loop, and the
actions and rewards are gathered at the end.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from .. import resolve_device
from ..track.geometry import TrackGeometry
from . import car_racing as env


def _checked(bank: TrackGeometry, track_ids, device):
    """(track_ids on the bank's device, int32), after checking that the bank
    lies on `device`; track_ids=None gives arange(U), one env per track."""
    dev = resolve_device(device)
    have = bank.tex.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the track bank lies on {have}, not on {dev}: "
                         "build it with device=...")
    if track_ids is None:
        return torch.arange(bank.tex.shape[0], dtype=torch.int32, device=have)
    return torch.as_tensor(track_ids).to(device=have, dtype=torch.int32)


def gather_geom(bank: TrackGeometry, ids) -> TrackGeometry:
    """The sub-bank of tracks `ids` (a per-env view of a bank, or a rank's
    block of a stacked per-env geometry)."""
    ids = torch.as_tensor(ids).to(device=bank.tex.device, dtype=torch.long)
    return TrackGeometry(*(f[ids] for f in bank))


def init_batch(bank: TrackGeometry, track_ids=None, device="cuda"):
    return env.init(bank, _checked(bank, track_ids, device))


def reset_batch(bank: TrackGeometry, render: bool = True, track_ids=None,
                device="cuda"):
    return env.reset(bank, _checked(bank, track_ids, device), render=render)


def step_batch(states, bank: TrackGeometry, actions, render: bool = True,
               track_ids=None, device="cuda"):
    """One step of every env: physics, tiles, rewards and, when render is
    true, both frames through one K2 launch."""
    return env.step(states, bank, _checked(bank, track_ids, device), actions,
                    render=render)


class Rollout(NamedTuple):
    actions: torch.Tensor      # (T, B, 3)
    rewards: torch.Tensor      # (T, B) step rewards
    reward_alive: torch.Tensor  # (B,) summed over steps begun not done
    trajectory: Optional[env.StepResult]  # stacked (T, B, ...) or None


def _run(states, bank, track_ids, n_steps, render, auto_reset, keep,
         choose: Callable, first_res=None):
    actions, rewards, traj = [], [], []
    alive_sum = torch.zeros_like(states.reward)
    res = first_res
    for _ in range(n_steps):
        a = choose(states, res)
        alive = ~states.done
        states, res = env.step(states, bank, track_ids, a, render=render)
        if auto_reset:
            states = env.auto_reset(states, bank, track_ids)
        actions.append(a)
        rewards.append(res.reward)
        alive_sum = alive_sum + torch.where(alive, res.reward,
                                            torch.zeros_like(res.reward))
        if keep:
            traj.append(res)
    stacked = None
    if keep:
        info = env.StepInfo(*(torch.stack(f) for f in
                              zip(*(r.info for r in traj))))
        stacked = env.StepResult(*(torch.stack(f) for f in
                                   zip(*(r[:4] for r in traj))), info)
    return states, res, Rollout(torch.stack(actions), torch.stack(rewards),
                                alive_sum, stacked)


def rollout_constant(states, bank: TrackGeometry, actions, n_steps: int,
                     render: bool = True, auto_reset: bool = True,
                     track_ids=None, device="cuda",
                     keep_trajectory: bool = False):
    """n_steps with a fixed per-env action (B, 3). Returns (final states,
    Rollout)."""
    ids = _checked(bank, track_ids, device)
    states, _, out = _run(states, bank, ids, n_steps, render, auto_reset,
                          keep_trajectory, lambda s, r: actions)
    return states, out


def rollout_policy(bank: TrackGeometry, policy: Callable, carry,
                   n_steps: int, render: bool = True, auto_reset: bool = True,
                   track_ids=None, device="cuda",
                   keep_trajectory: bool = False):
    """Closed loop from a reset: actions, carry = policy(carry, states,
    prev_res), where prev_res is the previous StepResult (the reset's
    first). Returns (final states, final carry, Rollout)."""
    ids = _checked(bank, track_ids, device)
    states, res0 = env.reset(bank, ids, render=render)
    box = [carry]

    def choose(states, res):
        a, box[0] = policy(box[0], states, res)
        return a

    states, _, out = _run(states, bank, ids, n_steps, render, auto_reset,
                          keep_trajectory, choose, first_res=res0)
    return states, box[0], out


def _shard_envs(mesh, bank: TrackGeometry, B: int, track_ids):
    """(the rank's bank, its track ids): with track_ids=None the bank is a
    stacked per-env geometry and the rank keeps its envs' tracks (ids
    local), else the bank is shared and the rank keeps its envs' ids."""
    from ..parallel import rows

    mine = rows(B, mesh)
    if track_ids is None:
        return gather_geom(bank, torch.arange(B)[mine]), None
    return bank, torch.as_tensor(track_ids)[mine]


def _gathered(out: Rollout, mesh) -> Rollout:
    from ..parallel import gather_rows

    return Rollout(gather_rows(out.actions, mesh, 1),
                   gather_rows(out.rewards, mesh, 1),
                   gather_rows(out.reward_alive, mesh, 0), None)


def rollout_constant_sharded(mesh, states, bank: TrackGeometry, actions,
                             n_steps: int, render: bool = True,
                             auto_reset: bool = True, track_ids=None):
    """`rollout_constant` with the envs split over the mesh's ranks. Every
    rank passes the global states (B, ...) and actions (B, 3), on its
    device; B must divide by the world size. Returns (the rank's final
    states, Rollout of the global (T, B, 3) actions, (T, B) rewards and
    (B,) alive sums, gathered to every rank)."""
    from ..parallel import shard_batch

    B = actions.shape[0]
    bank, ids = _shard_envs(mesh, bank, B, track_ids)
    states, out = rollout_constant(
        shard_batch(states, mesh), bank, shard_batch(actions, mesh), n_steps,
        render=render, auto_reset=auto_reset, track_ids=ids,
        device=mesh.device)
    return states, _gathered(out, mesh)


def rollout_policy_sharded(mesh, params, bank: TrackGeometry,
                           policy: Callable, carry, n_steps: int,
                           render: bool = True, auto_reset: bool = True,
                           track_ids=None):
    """Closed loop from a reset with the envs and the policy's carry split
    over the mesh's ranks, the params and a shared bank on every rank.

    policy(params, carry, states, prev_res) -> ((B_rank, 3) actions, carry),
    as in the JAX package (`diffusion.env_policy_fn` adapts a ring policy).
    Every rank passes the global carry: its tensor leaves lead with the
    env axis and are split with the envs (the ring policy's `uid` keeps
    each env's global id); other leaves (the ring's frame counter) pass as
    they are. B = the number of envs (len(track_ids), or the stacked
    bank's size) must divide by the world size.

    Returns (the rank's final states, the rank's final carry, the global
    (T, B, 3) actions and (T, B) rewards, gathered to every rank)."""
    from ..parallel import shard_batch

    B = (bank.tex.shape[0] if track_ids is None
         else torch.as_tensor(track_ids).shape[0])
    bank, ids = _shard_envs(mesh, bank, B, track_ids)
    states, carry, out = rollout_policy(
        bank, functools.partial(policy, params), shard_batch(carry, mesh),
        n_steps, render=render, auto_reset=auto_reset, track_ids=ids,
        device=mesh.device)
    out = _gathered(out, mesh)
    return states, carry, out.actions, out.rewards
