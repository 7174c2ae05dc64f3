"""The CarRacing environment as batched functions over explicit state.

Counterpart of `state_policy_diffusionmodel_tpu/envs/car_racing.py`, which
is written for one env and vmapped. Here every function steps B envs at
once; tracks come from a bank (`track.TrackGeometry` with a leading U axis)
and `track_ids` (B,) names each env's track.

Semantics, as in the JAX module (car_racing.py:449-483 of the reference):
steer(-a0), gas(a1), brake(a2); one physics tick; reward -0.1 a frame and
+1000/n per newly visited tile; done when every tile is visited or the car
leaves the playfield (step reward -100). A wheel is on a tile when its
centre lies within TRACK_WIDTH of the tile's centerline segment; grass
gives 0.6x friction. `reset` places the car at the start and takes one
step without an action.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import physics
from ..physics import CarState, constants as C
from ..physics.car import rdiv, wheel_positions
from ..render import Overlay, raster
from ..track.generator import PLAYFIELD, TRACK_WIDTH
from ..track.geometry import TrackGeometry, nearest_segment

F32 = torch.float32


class EnvState(NamedTuple):
    car: CarState
    visited: torch.Tensor        # (B, P) bool per-tile visited flags
    tile_count: torch.Tensor     # (B,) int32
    reward: torch.Tensor         # (B,) cumulative reward
    prev_reward: torch.Tensor    # (B,)
    t: torch.Tensor              # (B,) sim time
    done: torch.Tensor           # (B,) bool
    wheel_on_road: torch.Tensor  # (B, 4) bool, contact after the last step
    wheel_tile: torch.Tensor     # (B, 4) int64 nearest tile per wheel


class StepInfo(NamedTuple):
    """The reference step() info dict (car_racing.py:477-481)."""

    car_position: torch.Tensor   # (B, 2)
    car_velocity: torch.Tensor   # (B, 2) hull COM velocity
    car_angle: torch.Tensor      # (B,)


class StepResult(NamedTuple):
    obs: torch.Tensor            # (B, 96, 96, 3) uint8 state frame
    augmented: torch.Tensor      # (B, 96, 96, 3) uint8 augmented frame
    reward: torch.Tensor         # (B,) step reward
    done: torch.Tensor           # (B,) bool
    info: StepInfo


def _wheel_contacts(car: CarState, bank: TrackGeometry, track_ids):
    """Nearest tile of each wheel and whether the wheel is on the road."""
    c, s = torch.cos(car.angle)[:, None], torch.sin(car.angle)[:, None]
    wp = wheel_positions(car.pos.device)
    wheel_world = car.pos[:, None] + torch.stack(
        [c * wp[:, 0] - s * wp[:, 1], s * wp[:, 0] + c * wp[:, 1]], -1)
    q = nearest_segment(bank, track_ids, wheel_world)
    return q.idx, q.dist <= TRACK_WIDTH


def _friction(on_road: torch.Tensor) -> torch.Tensor:
    return torch.where(on_road, C.FRICTION_LIMIT,
                       C.FRICTION_LIMIT * C.GRASS_FRICTION).to(F32)


def init(bank: TrackGeometry, track_ids: torch.Tensor) -> EnvState:
    """Fresh states with each car at its track's start (before the reset
    step)."""
    start = bank.start[track_ids]
    car = physics.create(start[:, 0], start[:, 1], start[:, 2])
    idx, on_road = _wheel_contacts(car, bank, track_ids)
    B, P = track_ids.shape[0], bank.valid.shape[-1]
    dev = start.device
    zf = torch.zeros((B,), dtype=F32, device=dev)
    return EnvState(
        car=car, visited=torch.zeros((B, P), dtype=torch.bool, device=dev),
        tile_count=torch.zeros((B,), dtype=torch.int32, device=dev),
        reward=zf, prev_reward=zf, t=zf,
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        wheel_on_road=on_road, wheel_tile=idx)


def newly_visited(visited: torch.Tensor, idx: torch.Tensor,
                  on_road: torch.Tensor) -> torch.Tensor:
    """(B, P) tiles first touched this step.

    The JAX code writes `zeros.at[idx].set(on_road)`; where two wheels name
    one tile, the later wheel's value stands (XLA on the CPU). A scatter
    with duplicate indices is not deterministic on CUDA, so here a wheel
    counts only if no later wheel names its tile, and the marks are taken
    with an order-free max."""
    later = torch.ones((4, 4), dtype=torch.bool, device=idx.device).triu(1)
    shadowed = ((idx[:, :, None] == idx[:, None, :]) & later).any(-1)
    marks = torch.zeros(visited.shape, dtype=torch.uint8, device=idx.device)
    marks.scatter_reduce_(1, idx, (on_road & ~shadowed).to(torch.uint8),
                          reduce="amax")
    return marks.bool() & ~visited


def physics_step(state: EnvState, bank: TrackGeometry, track_ids,
                 action: Optional[torch.Tensor]) -> EnvState:
    """Everything of `step` except rendering; action (B, 3) or None."""
    car = state.car
    if action is not None:
        car = physics.apply_action(car, action)
    car = physics.step(car, _friction(state.wheel_on_road), C.DT)

    idx, on_road = _wheel_contacts(car, bank, track_ids)
    newly = newly_visited(state.visited, idx, on_road)
    n_new = newly.sum(-1)
    n = bank.n[track_ids]
    tile_count = state.tile_count + n_new.to(torch.int32)
    reward = state.reward + rdiv(1000.0, n.to(F32)) * n_new.to(F32)
    if action is not None:
        reward = reward - 0.1
        car = car._replace(fuel_spent=torch.zeros_like(car.fuel_spent))
    out = (car.pos[:, 0].abs() > PLAYFIELD) | (car.pos[:, 1].abs() > PLAYFIELD)
    return EnvState(
        car=car, visited=state.visited | newly, tile_count=tile_count,
        reward=reward, prev_reward=state.prev_reward, t=state.t + C.DT,
        done=(tile_count >= n) | out, wheel_on_road=on_road, wheel_tile=idx)


def _finish(state: EnvState, had_action: bool):
    """Step-reward accounting (car_racing.py:461-476)."""
    if had_action:
        step_reward = state.reward - state.prev_reward
    else:
        step_reward = torch.zeros_like(state.reward)
    out = ((state.car.pos[:, 0].abs() > PLAYFIELD)
           | (state.car.pos[:, 1].abs() > PLAYFIELD))
    step_reward = torch.where(out, torch.full_like(step_reward, -100.0),
                              step_reward)
    return state._replace(prev_reward=state.reward), step_reward


def render_score(state: EnvState, had_action: bool) -> torch.Tensor:
    """What the score label shows: the reward before this frame's -0.1
    (the reference renders before deducting it, car_racing.py:459 vs
    :464)."""
    return state.reward + (0.1 if had_action else 0.0)


def step(state: EnvState, bank: TrackGeometry, track_ids,
         action: Optional[torch.Tensor], overlay: Optional[Overlay] = None,
         render: bool = True) -> tuple[EnvState, StepResult]:
    """One step of B envs; frames go through `raster.render_batch_banked`
    (one K2 launch) when render is true, else they are zeros."""
    state = physics_step(state, bank, track_ids, action)
    state, step_reward = _finish(state, action is not None)
    if render:
        obs, augm = raster.render_batch_banked(
            state.car, bank.tex, track_ids, overlay,
            score=render_score(state, action is not None))
    else:
        obs = torch.zeros((track_ids.shape[0], 96, 96, 3), dtype=torch.uint8,
                          device=state.reward.device)
        augm = obs
    info = StepInfo(car_position=state.car.pos,
                    car_velocity=physics.hull_com_velocity(state.car),
                    car_angle=state.car.angle)
    return state, StepResult(obs, augm, step_reward, state.done, info)


def reset(bank: TrackGeometry, track_ids,
          render: bool = True) -> tuple[EnvState, StepResult]:
    """Reference reset(): place the cars, then one step without an action
    (car_racing.py:421-447)."""
    return step(init(bank, track_ids), bank, track_ids, None, render=render)


def reset_car(state: EnvState, saved: torch.Tensor) -> EnvState:
    """Restore saved car states (B, 30) into the running episodes
    (envWrapper.reset_car)."""
    return state._replace(car=physics.restore_state(saved))


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def auto_reset(state: EnvState, bank: TrackGeometry, track_ids) -> EnvState:
    """Where done, restart the episode on the same track."""
    fresh = init(bank, track_ids)
    car = CarState(*(_where(state.done, f, s)
                     for f, s in zip(fresh.car, state.car)))
    rest = (_where(state.done, f, s) for f, s in zip(fresh[1:], state[1:]))
    return EnvState(car, *rest)
