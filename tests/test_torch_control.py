"""Parity of the PyTorch port's PID controllers, ring buffers and PID
drivers with the JAX package, on CPU.

Tolerances:
- PID updates and ring-buffer means: 1e-6 over 200 random updates of 8
  controllers, against JAX un-jitted (the same float32 operations; under
  jit XLA turns the division by dt into a multiply by 50, an ulp apart,
  which at outputs of ~100 is more than 1e-6).
- The drivers, teacher-forced: the JAX env drives 8 envs on the 4-track
  bank for 60 steps with JAX's lane follower; at every step both packages'
  drivers get the same frames, speed, car state and controller state. The
  pixel decisions are equal: each mode's lane mask and column, the found
  flag (the freeze decision), the grass edges and road middles. Actions and
  the new controller state agree within 1e-5 (atan2, arctan and arccos
  may differ from XLA's by an ulp).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import control as JC
from state_policy_diffusionmodel_tpu import envs as JE
from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu.control import drivers as jdrv
from state_policy_diffusionmodel_tpu.envs.vector import gather_geom
from state_policy_diffusionmodel_torch import control as TC
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.control import drivers as tdrv
from state_policy_diffusionmodel_torch.physics import CarState

from test_torch_policy import torch_threads

PID_ATOL = 1e-6
DRIVER_ATOL = 1e-5


one_torch_thread = torch_threads(1)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, msg=""):
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        np.testing.assert_allclose(_np(g).astype(np.float64),
                                   _np(w).astype(np.float64), rtol=0,
                                   atol=atol, err_msg=msg)


def test_pid_and_ring_buffers_match_jax():
    """8 controllers with the lane follower's gains (steer and velocity)
    and random ones, 200 random measurements each."""
    rng = np.random.default_rng(0)
    B = 8
    gains = [(0.8, 0.01, 0.06, 0.0), (0.005, 0.001, 0.0005, 30.0),
             tuple(rng.uniform(0, 1, 3)) + (rng.normal(),)]
    jupd = jax.vmap(JC.pid_update, in_axes=(None, 0, 0))
    for kp, ki, kd, sp in gains:
        jp = JC.pid_params(kp, ki, kd, sp)
        tp = TC.pid_params(kp, ki, kd, sp)
        js = jax.vmap(lambda _: JC.pid_init())(jnp.arange(B))
        ts = TC.pid_init(B)
        for _ in range(200):
            v = (rng.normal(size=B) * rng.choice([0.3, 3.0, 30.0])).astype(
                np.float32)
            jo, js = jupd(jp, js, jnp.asarray(v))
            to, ts = TC.pid_update(tp, ts, _t(v))
            _close((to,) + tuple(ts), (jo,) + tuple(js), PID_ATOL)
    jpush = jax.vmap(JC.ring_push)
    jmean = jax.vmap(JC.ring_mean)
    for n in (3, 7, 10):
        jr = jax.vmap(lambda _: JC.ring_init(n))(jnp.arange(B))
        tr = TC.ring_init(B, n)
        for _ in range(200):
            v = (rng.normal(size=B) * 5).astype(np.float32)
            jr, tr = jpush(jr, jnp.asarray(v)), TC.ring_push(tr, _t(v))
            np.testing.assert_array_equal(_np(tr.buf), _np(jr.buf))
            _close([TC.ring_mean(tr)], [jmean(jr)], PID_ATOL)


def test_lane_column_takes_the_first_of_equal_minima():
    """Two lane pixels equally far from col 48: both packages take the
    left one (argmin's first minimum); no lane pixel: not found."""
    magenta = np.array([200, 0, 200], np.uint8)
    frames = np.zeros((3, 96, 96, 3), np.uint8)
    frames[0, 60, [45, 51]] = magenta
    frames[1, 60, [10, 90, 47]] = magenta
    frames[2, 59] = magenta                          # off the strip row
    col, found = tdrv.lane_column(_t(frames), TC.MODES.index("middle"))
    mask = jax.vmap(jdrv._lane_mask_row, in_axes=(0, None))(
        jnp.asarray(frames), 2)
    want = np.argmin(np.where(np.asarray(mask),
                              np.abs(np.arange(96) - 48.0), 1e9), -1)
    np.testing.assert_array_equal(_np(col), want.astype(np.float32))
    np.testing.assert_array_equal(_np(col), [45.0, 47.0, 0.0])
    np.testing.assert_array_equal(_np(found), np.asarray(mask).any(-1))
    np.testing.assert_array_equal(_np(found), [True, True, False])


@pytest.mark.parametrize("pattern", ["both", "left_only", "right_only",
                                     "none", "at_48", "random"])
def test_grass_edges_and_middle_match_jax(pattern):
    rng = np.random.default_rng(len(pattern))
    B = 16
    line = np.zeros((B, 96), bool)
    for b in range(B):
        lo, hi = sorted(rng.integers(0, 96, 2))
        if pattern in ("both", "left_only"):
            line[b, :lo // 2 + 1] = True
        if pattern in ("both", "right_only"):
            line[b, 48 + hi // 2:] = True
        if pattern == "at_48":
            line[b, 48] = True
        if pattern == "random":
            line[b] = rng.random(96) < 0.2
    tl = _t(line)
    for d in ("left", "right"):
        want = jax.vmap(lambda l: jdrv._edge_from_middle(l, d))(
            jnp.asarray(line))
        np.testing.assert_array_equal(_np(tdrv._edge_from_middle(tl, d)),
                                      np.asarray(want))
    want = jax.vmap(jdrv._middle_point)(jnp.asarray(line))
    np.testing.assert_array_equal(_np(tdrv._middle_point(tl)),
                                  np.asarray(want))


def _tstate(jst):
    """A JAX LaneFollowState (batched) as the port's."""
    return TC.LaneFollowState(
        TC.PIDState(*map(_t, jst.pid_steer)),
        TC.PIDState(*map(_t, jst.pid_vel)),
        *(TC.RingBuffer(_t(r.buf)) for r in (jst.err_buf, jst.err_buf2,
                                              jst.vel_buf)),
        _t(jst.last_action))


def _jcar(tcar_np):
    return JE.car_racing.CarState(*(jnp.asarray(v) for v in tcar_np))


@pytest.fixture(scope="module")
def bank4():
    bank = TT.load_or_build_bank(4, bake=True, device="cpu")
    jbank = JT.TrackGeometry(*(jnp.asarray(x.numpy()) for x in bank))
    return bank, jbank


def test_drivers_teacher_forced_match_jax(bank4):
    """8 envs x 60 steps, the JAX env driven by its lane follower (mode
    middle): at every step every driver of both packages on the same
    inputs. The lane followers of all five modes keep their own state,
    each taught by its JAX twin; every fifth step three envs see a frame
    whose strip row is blank."""
    bank, jbank = bank4
    B, n_steps = 8, 60
    ids = np.arange(B, dtype=np.int32) % 4
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    jgeoms = jax.vmap(lambda t: gather_geom(jbank, t))(jids)
    js, jres = jax.jit(lambda i: JE.vector.reset_batch(
        jbank, render=True, track_ids=i))(jids)
    jstep = jax.jit(lambda s, a: JE.vector.step_batch(
        s, jbank, a, render=True, track_ids=jids))
    jlane = jax.jit(jax.vmap(JC.lane_follow, in_axes=(None, 0, 0, 0)))
    jcenter = jax.jit(jax.vmap(JC.center_follow, in_axes=(0, 0, None)))
    jsin = jax.jit(jax.vmap(partial(JC.sinusoidal, amplitude=5.0),
                            in_axes=(0, 0, None)))
    jparams = [JC.lane_follow_params(m, 30.0) for m in JC.MODES]
    tparams = [TC.lane_follow_params(m, 30.0) for m in TC.MODES]
    jstates = [jax.vmap(lambda _: JC.lane_follow_init())(jnp.arange(B))
               for _ in JC.MODES]
    found_any, lost_any = np.zeros(5, bool), np.zeros(5, bool)
    drive = None
    for k in range(n_steps):
        augm, obs = np.array(jres.augmented), np.asarray(jres.obs)
        if k % 5 == 4:
            # the strip row blanked in three envs: no lane pixel there, so
            # those controllers take the freeze path
            augm[:3, tdrv.STRIP_ROW] = 0
        speed = np.linalg.norm(np.asarray(jres.info.car_velocity),
                               axis=-1).astype(np.float32)
        where = f"step {k}"
        for m in range(5):
            # the pixel decisions: mask, column, found (freeze) flag
            mask = jax.vmap(jdrv._lane_mask_row, in_axes=(0, None))(
                jnp.asarray(augm), m)
            np.testing.assert_array_equal(
                _np(tdrv._lane_mask_row(_t(augm), m)), np.asarray(mask),
                err_msg=where)
            col, found = tdrv.lane_column(_t(augm), m)
            want_col = np.argmin(np.where(
                np.asarray(mask), np.abs(np.arange(96) - 48.0), 1e9), -1)
            np.testing.assert_array_equal(_np(col), want_col, err_msg=where)
            np.testing.assert_array_equal(_np(found),
                                          np.asarray(mask).any(-1),
                                          err_msg=where)
            found_any[m] |= _np(found).any()
            lost_any[m] |= (~_np(found)).any()
            # the controller from the JAX twin's state
            jst = jstates[m]
            tst = _tstate(jst)
            ja, jnew = jlane(jparams[m], jst, jnp.asarray(augm),
                             jnp.asarray(speed))
            ta, tnew = TC.lane_follow(tparams[m], tst, _t(augm), _t(speed))
            _close([ta], [ja], DRIVER_ATOL, f"{where} mode {m} action")
            _close(tnew, jnew, DRIVER_ATOL, f"{where} mode {m} state")
            # frozen envs keep their state and repeat their last action
            lost = ~_np(found)
            np.testing.assert_array_equal(_np(ta)[lost],
                                          np.asarray(jst.last_action)[lost])
            jstates[m] = jnew
            if m == 2:
                drive = ja
        # centre follower: grass edges, then the action
        grass = np.asarray(jax.vmap(jdrv._grass_mask)(jnp.asarray(obs)))
        np.testing.assert_array_equal(_np(tdrv._grass_mask(_t(obs))), grass)
        for row in (55, 74):
            np.testing.assert_array_equal(
                _np(tdrv._middle_point(_t(grass[:, row]))),
                np.asarray(jax.vmap(jdrv._middle_point)(
                    jnp.asarray(grass[:, row]))), err_msg=where)
        _close([TC.center_follow(_t(obs), _t(speed), 30.0)],
               [jcenter(jnp.asarray(obs), jnp.asarray(speed), 30.0)],
               DRIVER_ATOL, f"{where} center_follow")
        # sinusoidal weaver on the same cars
        car_np = [np.asarray(f) for f in js.car]
        tcar = CarState(*(_t(f) for f in car_np))
        _close([TC.sinusoidal(tcar, bank, tids, float(k), amplitude=5.0)],
               [jsin(_jcar(car_np), jgeoms, jnp.float32(k))],
               DRIVER_ATOL, f"{where} sinusoidal")
        js, jres = jstep(js, drive)
    # the run saw the lane found and lost (the freeze path)
    assert found_any[2] and lost_any[2], (found_any, lost_any)
    assert int(np.asarray(js.tile_count).min()) > 0
