"""Parity of the PyTorch port's batched car physics with the JAX package, on
CPU, and the reader of the golden car states.

Inputs are random batched states made with numpy. JAX runs vmapped without
jit: under jit XLA fuses the elementwise chains and contracts some of them
into FMAs, which the port (one PyTorch kernel per operation) does not.
The two packages share every float32 operation and its order; what
differs is the sin and cos implementation: XLA's and PyTorch's differ by
one ulp on ~5% of float32 angles. So a step is checked twice: with the
port's sin and cos replaced by JAX's, where every field must be equal, and
as it runs, held to 1e-6 of each field's largest magnitude in the batch
(an ulp of an angle term moves a cancelling torque sum by a few 1e-6 of
its own size).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import physics as JP
from state_policy_diffusionmodel_torch import physics as TP
from state_policy_diffusionmodel_torch.envs import car_racing as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_STATES = os.path.join(REPO, "tests", "fixtures", "golden_states.pkl")
RTOL = 1e-6


def _close(got, want, what="", exact=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    err = np.abs(got.astype(np.float64) - want).max()
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= RTOL * scale, f"{what}: error {err:.3g} at scale {scale:.3g}"


def random_states(seed, B=64):
    rng = np.random.default_rng(seed)
    f = lambda *a: a[0](*a[1:]).astype(np.float32)  # noqa: E731
    brake = rng.choice([0.0, 0.0, 0.3, 0.95], size=(B, 1)) * np.ones((1, 4))
    fields = dict(
        pos=f(rng.uniform, -300, 300, (B, 2)),
        angle=f(rng.uniform, -np.pi, np.pi, (B,)),
        vel=f(rng.normal, 0, 20, (B, 2)),
        angular_vel=f(rng.normal, 0, 2, (B,)),
        gas=f(rng.uniform, 0, 1, (B, 4)) * np.float32([0, 0, 1, 1]),
        brake=brake.astype(np.float32),
        steer=f(rng.uniform, -0.5, 0.5, (B, 4)) * np.float32([1, 1, 0, 0]),
        joint_angle=f(rng.uniform, -0.4, 0.4, (B, 4)),
        phase=f(rng.uniform, -10, 10, (B, 4)),
        omega=f(rng.normal, 0, 60, (B, 4)),
        fuel_spent=np.zeros(B, np.float32),
    )
    # a few cars at the Box2D speed and spin caps
    fields["vel"][:3] *= 20
    fields["angular_vel"][3:5] = 90.0
    return fields


def both(fields):
    return (TP.CarState(**{k: torch.from_numpy(v) for k, v in fields.items()}),
            JP.CarState(**{k: jnp.asarray(v) for k, v in fields.items()}))


def _assert_cars_close(got, want, exact=False):
    for name in TP.CarState._fields:
        _close(getattr(got, name), getattr(want, name), name, exact)


@pytest.fixture()
def jax_trig(monkeypatch):
    """torch.sin and torch.cos computed by JAX, bit for bit."""
    for name, fn in (("sin", jnp.sin), ("cos", jnp.cos)):
        monkeypatch.setattr(torch, name, lambda x, fn=fn: torch.from_numpy(
            np.asarray(fn(jnp.asarray(x.numpy())))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax(seed):
    tcar, jcar = both(random_states(seed))
    rng = np.random.default_rng(seed + 10)
    friction = rng.choice([400.0, 240.0], size=(64, 4)).astype(np.float32)
    got = TP.step(tcar, torch.from_numpy(friction))
    want = jax.vmap(JP.step)(jcar, jnp.asarray(friction))
    _assert_cars_close(got, want)
    assert float(np.abs(np.asarray(want.vel)).max()) > 50   # caps exercised


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_with_jax_trig_is_exact(seed, jax_trig):
    tcar, jcar = both(random_states(seed))
    rng = np.random.default_rng(seed + 10)
    friction = rng.choice([400.0, 240.0], size=(64, 4)).astype(np.float32)
    _assert_cars_close(TP.step(tcar, torch.from_numpy(friction)),
                       jax.vmap(JP.step)(jcar, jnp.asarray(friction)),
                       exact=True)


@pytest.mark.parametrize("seed", [3, 4])
def test_apply_functions_match_jax(seed):
    tcar, jcar = both(random_states(seed))
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    _assert_cars_close(TP.apply_action(tcar, torch.from_numpy(act)),
                       jax.vmap(JP.apply_action)(jcar, jnp.asarray(act)))
    for t_fn, j_fn, col in ((TP.apply_gas, JP.apply_gas, 1),
                            (TP.apply_brake, JP.apply_brake, 2),
                            (TP.apply_steer, JP.apply_steer, 0)):
        _assert_cars_close(t_fn(tcar, torch.from_numpy(act[:, col])),
                           jax.vmap(j_fn)(jcar, jnp.asarray(act[:, col])))


def test_create_and_hull_velocity_match_jax():
    rng = np.random.default_rng(5)
    a, x, y = (rng.uniform(-3, 3, 16).astype(np.float32) for _ in range(3))
    _assert_cars_close(
        TP.create(torch.from_numpy(a), torch.from_numpy(x),
                  torch.from_numpy(y)),
        jax.vmap(JP.create)(jnp.asarray(a), jnp.asarray(x), jnp.asarray(y)))
    tcar, jcar = both(random_states(6))
    _close(TP.hull_com_velocity(tcar), jax.vmap(JP.hull_com_velocity)(jcar),
           "hull_com_velocity")


def test_save_restore_round_trip_matches_jax():
    tcar, jcar = both(random_states(7))
    saved_t = TP.save_state(tcar)
    saved_j = jax.vmap(JP.save_state)(jcar)
    _close(saved_t, saved_j, "save_state")
    _assert_cars_close(TP.restore_state(saved_t),
                       jax.vmap(JP.restore_state)(jnp.asarray(saved_t.numpy())))
    # the JAX round trip is not exact (joint angles reset, hull COM
    # velocity stored); the port's is the same map
    back = TP.restore_state(saved_t)
    _close(back.pos, jcar.pos, "pos")
    _close(back.joint_angle, np.asarray(jcar.steer), "joint_angle")


def test_multi_step_rollout_stays_close():
    """20 steps from one random batch: the float32 paths stay together
    (the map is not chaotic over 0.4 s of sim time without contacts)."""
    tcar, jcar = both(random_states(8, B=16))
    fr = np.full((16, 4), 400.0, np.float32)
    jstep = jax.vmap(JP.step)
    for _ in range(20):
        tcar = TP.step(tcar, torch.from_numpy(fr))
        jcar = jstep(jcar, jnp.asarray(fr))
    for name in ("pos", "angle", "vel"):
        got, want = getattr(tcar, name).numpy(), np.asarray(getattr(jcar, name))
        assert np.abs(got - want).max() <= 1e-4 * max(1, np.abs(want).max()), name


def test_duplicate_wheel_tiles_keep_the_last_wheel():
    """Two wheels on one tile: JAX's `.at[idx].set(on_road)` keeps the later
    wheel's value on the CPU; the port's deterministic form does too."""
    P = 8
    cases = [([1, 1, 3, 4], [True, False, True, False]),
             ([1, 1, 3, 4], [False, True, False, False]),
             ([2, 2, 2, 2], [True, True, True, False]),
             ([2, 2, 2, 2], [False, False, False, True]),
             ([0, 5, 0, 5], [True, True, False, False]),
             ([6, 7, 6, 6], [False, True, True, True])]
    visited = np.zeros((len(cases), P), bool)
    visited[1, 1] = True            # already visited: not new
    visited[5, 6] = True
    idx = np.array([c[0] for c in cases])
    on = np.array([c[1] for c in cases])
    want = np.stack([
        np.asarray(jnp.zeros(P, bool).at[jnp.asarray(i)].set(jnp.asarray(o))
                   & ~jnp.asarray(v))
        for i, o, v in zip(idx, on, visited)])
    got = tenv.newly_visited(torch.from_numpy(visited), torch.from_numpy(idx),
                             torch.from_numpy(on))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, 1] and want[2, 2] is np.False_ and want[3, 2]


def test_golden_states_read_without_the_jax_package():
    """The port reads tests/fixtures/golden_states.pkl (a pickle of the JAX
    package's CarState) to the same values as pickle.load, and a fresh
    interpreter that reads it imports no JAX module."""
    with open(GOLDEN_STATES, "rb") as f:
        want = pickle.load(f)
    got = TP.load_pickled_states(GOLDEN_STATES, device="cpu")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for name in TP.CarState._fields:
            np.testing.assert_array_equal(getattr(g, name).numpy()[0],
                                          np.asarray(getattr(w, name)))
    code = ("import sys\n"
            "from state_policy_diffusionmodel_torch import physics\n"
            f"s = physics.load_pickled_states({GOLDEN_STATES!r}, 'cpu')\n"
            "print(len(s), sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, roots = out.stdout.split(" ", 1)
    assert n == "5"
    assert not {"jax", "jaxlib", "flax", "state_policy_diffusionmodel_tpu"} \
        & set(eval(roots))


def test_golden_states_reader_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps([os.getcwd]))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        TP.load_pickled_states(str(path), device="cpu")
