"""Parity of the PyTorch port's batched env, rollouts and closed loop with
the JAX package, on CPU.

JAX runs its env jitted and vmapped over a 4-track bank with `track_ids`;
the port runs the same envs batched. Rewards, tile counts and done flags
must be equal. Positions are held to 1e-3 world units after 40 steps
(0.03 % of the 333-unit playfield): XLA fuses and contracts the jitted
physics, and its sin and cos differ from PyTorch's by an ulp on ~5% of
angles, so the two trajectories part by float32 rounding that the steps
compound (the exact single-step check is in test_torch_physics.py).
Frames may differ by at most 30 of 27,648 bytes (the budget of
tests/test_render_golden.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu import envs as JE
from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu.envs.vector import gather_geom
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch import envs as TE
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.envs import vector as tv
from state_policy_diffusionmodel_torch.train import load_stats

# the width-8 policy pair (a module fixture) and the chain tolerance
from test_torch_policy import CHAIN_ATOL, RUN_DIR, _jax_ring_noise, width8  # noqa: F401

POS_ATOL = 1e-3
FRAME_BUDGET = 30


@pytest.fixture(scope="module")
def bank4():
    bank = TT.load_or_build_bank(4, bake=True, device="cpu")
    jbank = JT.TrackGeometry(*(jnp.asarray(x.numpy()) for x in bank))
    return bank, jbank


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _jstates(ts):
    """A port EnvState as the JAX one."""
    car = JE.car_racing.CarState(*(jnp.asarray(_np(f)) for f in ts.car))
    rest = [jnp.asarray(_np(f)) for f in ts[1:]]
    rest[-1] = rest[-1].astype(jnp.int32)              # wheel_tile
    return JE.EnvState(car, *rest)


def _actions(rng, B):
    a = np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(0.2, 1.0, B),
                  rng.choice([0.0, 0.0, 0.0, 0.5], B)], -1)
    return a.astype(np.float32)


def _count(a, b):
    return int((_np(a) != _np(b)).sum())


def _jax_step(jbank, ids, render=True):
    return jax.jit(lambda s, a: JE.vector.step_batch(
        s, jbank, a, render=render, track_ids=ids))


def test_env_matches_jax_over_40_steps(bank4):
    """8 envs x 40 steps, 4-track bank, random actions: rewards, tile
    counts and done flags equal, positions within POS_ATOL, frames within
    the byte budget."""
    bank, jbank = bank4
    B = 8
    ids = np.arange(B, dtype=np.int32) % 4
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    ts, tres = tv.reset_batch(bank, track_ids=tids, device="cpu")
    js, jres = jax.jit(lambda i: JE.vector.reset_batch(
        jbank, render=True, track_ids=i))(jids)
    jstep = _jax_step(jbank, jids)
    rng = np.random.default_rng(0)
    worst = []
    for k in range(41):
        np.testing.assert_array_equal(_np(tres.reward), _np(jres.reward))
        np.testing.assert_array_equal(_np(tres.done), _np(jres.done))
        np.testing.assert_array_equal(_np(ts.tile_count), _np(js.tile_count))
        np.testing.assert_array_equal(_np(ts.visited), _np(js.visited))
        np.testing.assert_array_equal(_np(ts.reward), _np(js.reward))
        np.testing.assert_allclose(_np(ts.car.pos), _np(js.car.pos),
                                   rtol=0, atol=POS_ATOL)
        np.testing.assert_allclose(_np(tres.info.car_velocity),
                                   _np(jres.info.car_velocity),
                                   rtol=0, atol=POS_ATOL * 50)
        frames = [max(_count(tres.obs[b], jres.obs[b]),
                      _count(tres.augmented[b], jres.augmented[b]))
                  for b in range(B)]
        worst.append(max(frames))
        assert max(frames) <= FRAME_BUDGET, (k, frames)
        if k == 40:
            break
        a = _actions(rng, B)
        ts, tres = tv.step_batch(ts, bank, torch.from_numpy(a),
                                 track_ids=tids, device="cpu")
        js, jres = jstep(js, jnp.asarray(a))
    print("worst frame byte difference per step:", worst)
    assert int(_np(ts.tile_count).min()) > 3           # the cars drove
    print("position difference after 40 steps:",
          np.abs(_np(ts.car.pos) - _np(js.car.pos)).max())


def test_auto_reset_and_reset_car_match_jax(bank4):
    bank, jbank = bank4
    B = 8
    ids = np.arange(B, dtype=np.int32) % 4
    tids = torch.from_numpy(ids)
    ts, _ = tv.reset_batch(bank, track_ids=tids, render=False, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(6):
        ts, _ = tv.step_batch(ts, bank, torch.from_numpy(_actions(rng, B)),
                              render=False, track_ids=tids, device="cpu")
    done = torch.tensor([True, False, True, False, False, True, False, True])
    ts = ts._replace(done=done)
    js = _jstates(ts)
    got = TE.auto_reset(ts, bank, tids)
    want = jax.vmap(lambda s, t: JE.auto_reset(s, gather_geom(jbank, t)))(
        js, jnp.asarray(ids))
    for name, g, w in zip(("car",) + TE.EnvState._fields[1:], got, want):
        for a, b in (zip(g, w) if name == "car" else [(g, w)]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    saved = np.random.default_rng(2).uniform(-2, 2, (B, 30)).astype(np.float32)
    got = TE.reset_car(ts, torch.from_numpy(saved))
    want = jax.vmap(JE.reset_car)(js, jnp.asarray(saved))
    for a, b in zip(got.car, want.car):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_rollout_constant_matches_jax(bank4):
    """20 steps without render, auto-reset on, per-env geometry (the bank
    with track_ids = arange(B)): step rewards equal; the loop keeps no
    frames unless asked."""
    bank, jbank = bank4
    a = np.tile(np.float32([[0.1, 0.8, 0.0]]), (4, 1))
    a[1] = [-0.3, 1.0, 0.0]
    ts = tv.init_batch(bank, device="cpu")
    ts, out = tv.rollout_constant(ts, bank, torch.from_numpy(a), 20,
                                  render=False, device="cpu")
    js = jax.vmap(JE.init)(jbank)
    js, traj = JE.vector.rollout_constant(js, jbank, jnp.asarray(a), 20,
                                          render=False)
    np.testing.assert_array_equal(_np(out.rewards), _np(traj.reward))
    np.testing.assert_array_equal(_np(ts.tile_count), _np(js.tile_count))
    assert out.trajectory is None and tuple(out.actions.shape) == (20, 4, 3)
    np.testing.assert_array_equal(_np(out.reward_alive),
                                  _np(traj.reward).sum(0))
    _, kept = tv.rollout_constant(tv.init_batch(bank, device="cpu"), bank,
                                  torch.from_numpy(a), 3, device="cpu",
                                  keep_trajectory=True)
    assert tuple(kept.trajectory.obs.shape) == (3, 4, 96, 96, 3)
    assert tuple(kept.trajectory.info.car_position.shape) == (3, 4, 2)


def test_closed_loop_matches_jax_rollout_policy(bank4, width8):
    """The ring policy drives the env: 4 envs x 12 frames (denoises at
    frames 0, 5 and 10) against JAX `rollout_policy` with its ring policy,
    x_T injected through init_noise_fn. Actions are held to the sampler
    chain's tolerance (test_torch_policy.py), tile counts must be equal."""
    bank, jbank = bank4
    jpol, jparams, tpol, tparams = width8
    stats = load_stats(RUN_DIR / "STATS.pkl")
    jfn = partial(jd.make_ring_policy(jpol, stats), jparams)
    jstates, jcarry, jtraj = JE.vector.rollout_policy(
        None, jbank, jfn, jd.init_ring_carry(jpol, 4), 12)
    tfn = td.make_ring_policy(
        tpol, stats, init_noise_fn=lambda uid, k0: torch.from_numpy(
            _jax_ring_noise(tpol.config, uid, k0)))
    states, carry, out = tv.rollout_policy(
        bank, td.env_policy(tfn, tparams), td.init_ring_carry(tpol, 4), 12,
        device="cpu", keep_trajectory=True)
    np.testing.assert_array_equal(_np(out.rewards), _np(jtraj.reward))
    np.testing.assert_array_equal(_np(states.tile_count),
                                  _np(jstates.tile_count))
    np.testing.assert_allclose(_np(out.trajectory.info.car_position),
                               _np(jtraj.info.car_position), rtol=0,
                               atol=POS_ATOL)
    jq = np.asarray(jcarry["queue"])
    np.testing.assert_allclose(_np(carry["queue"]), jq, rtol=0,
                               atol=CHAIN_ATOL)
    assert np.abs(jq).max() > 1e-3 and carry["k"] == 12
    frames = [_count(out.trajectory.obs[f, b], jtraj.obs[f, b])
              for f in range(12) for b in range(4)]
    assert max(frames) <= FRAME_BUDGET


def test_entry_points_check_the_bank_device(bank4):
    bank, _ = bank4
    with pytest.raises(ValueError, match="lies on cpu"):
        tv.init_batch(bank, device="meta")
