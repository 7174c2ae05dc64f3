"""Batched car dynamics: the reference tire model on one analytic rigid body.

Counterpart of `state_policy_diffusionmodel_tpu/physics/car.py`, which is
written for one car and vmapped. Here every field of `CarState` carries a
leading batch axis B, and each function steps all B cars at once. The
arithmetic follows the JAX code operation by operation, in float32: the
2x2 rotations are written out elementwise and rounded as the JAX matmuls
round them on the CPU (`dot2`), and constants enter as float32 values, as
JAX's weak typing makes them with x64 off.
"""

from __future__ import annotations

import functools
import pickle
from typing import NamedTuple

import numpy as np
import torch

from . import constants as C

F32 = torch.float32


class CarState(NamedTuple):
    """State of B cars, all float32 (reference `_save_state` layout,
    car_dynamics.py:138-178)."""

    pos: torch.Tensor          # (B, 2) hull body origin, world frame
    angle: torch.Tensor        # (B,) hull angle
    vel: torch.Tensor          # (B, 2) velocity of the assembly COM
    angular_vel: torch.Tensor  # (B,)
    gas: torch.Tensor          # (B, 4) per-wheel gas (rear wheels driven)
    brake: torch.Tensor        # (B, 4)
    steer: torch.Tensor        # (B, 4) steer target (front wheels)
    joint_angle: torch.Tensor  # (B, 4) steering joint angle
    phase: torch.Tensor        # (B, 4) wheel roll angle (rendering)
    omega: torch.Tensor        # (B, 4) wheel rolling angular velocity
    fuel_spent: torch.Tensor   # (B,)


@functools.lru_cache(maxsize=None)
def const(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-dim tensor on `device`. Dividing by it rounds once: on
    CUDA, PyTorch applies a Python-scalar divisor as a multiply by its
    reciprocal, which can land one ulp away."""
    return torch.full((), float(value), dtype=F32, device=device)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one float32 division (see `const`)."""
    return x / const(c, x.device)


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one float32 division; `c / x` on a tensor is
    `x.reciprocal() * c` in PyTorch."""
    return const(c, x.device) / x


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: PyTorch's CPU sqrt is
    not (it misses on ~0.7% of inputs), XLA's is. Taken in float64 and
    rounded once more, which is exact for a square root."""
    return torch.sqrt(x.double()).float()


def create(init_angle, init_x, init_y) -> CarState:
    """Cars at rest (`Car.__init__`, car_dynamics.py:51-136); each argument
    is a (B,) tensor, and the state lies on their device."""
    angle = torch.as_tensor(init_angle, dtype=F32)
    dev = angle.device
    B = angle.shape[0]
    z4 = torch.zeros((B, 4), dtype=F32, device=dev)
    z = torch.zeros((B,), dtype=F32, device=dev)
    return CarState(
        pos=torch.stack([torch.as_tensor(init_x, dtype=F32),
                         torch.as_tensor(init_y, dtype=F32)], -1),
        angle=angle.clone(), vel=torch.zeros((B, 2), dtype=F32, device=dev),
        angular_vel=z, gas=z4, brake=z4, steer=z4, joint_angle=z4,
        phase=z4, omega=z4, fuel_spent=z)


@functools.lru_cache(maxsize=None)
def table(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant float32 tensor on `device`, copied there once: a copy
    from host memory waits for the device's queue."""
    return torch.tensor(values, dtype=F32).to(device)


def wheel_positions(device: torch.device) -> torch.Tensor:
    """(4, 2) body-frame wheel anchors, float32."""
    return table(tuple(map(tuple, np.float32(C.WHEEL_POSITIONS).tolist())),
                 device)


def _wheel_mask(values, ref: torch.Tensor) -> torch.Tensor:
    return table(tuple(values), ref.device)


def apply_gas(car: CarState, gas: torch.Tensor) -> CarState:
    """Rear-wheel drive with a +0.1 per call ramp (car_dynamics.py:198-209);
    gas is (B,)."""
    gas = gas.to(F32).clamp(0.0, 1.0)
    diff = (gas[:, None] - car.gas).clamp(max=C.GAS_RAMP)
    rear = _wheel_mask([0.0, 0.0, 1.0, 1.0], car.gas)
    return car._replace(gas=car.gas + diff * rear)


def apply_brake(car: CarState, b: torch.Tensor) -> CarState:
    """All wheels brake (car_dynamics.py:211-217); b is (B,)."""
    return car._replace(brake=b.to(F32)[:, None].expand(-1, 4).contiguous())


def apply_steer(car: CarState, s: torch.Tensor) -> CarState:
    """Front wheels get the steering target (car_dynamics.py:219-225)."""
    front = _wheel_mask([1.0, 1.0, 0.0, 0.0], car.steer)
    return car._replace(steer=s.to(F32)[:, None] * front)


def apply_action(car: CarState, action: torch.Tensor) -> CarState:
    """Reference action convention, action (B, 3): steer(-a0), gas(a1),
    brake(a2) (car_racing.py:449-453)."""
    car = apply_steer(car, -action[:, 0])
    car = apply_gas(car, action[:, 1])
    return apply_brake(car, action[:, 2])


def dot2(a0, b0, a1, b1) -> torch.Tensor:
    """a0*b0 + a1*b1 rounded as XLA's CPU dot rounds a two-term product:
    the first product, then a fused multiply-add of the second. The FMA is
    taken in float64, which is exact but for a double rounding at float32
    halfway points."""
    acc = a0 * b0
    return (a1.double() * b1 + acc.double()).float() if torch.is_tensor(a1) \
        else (b1.double() * a1 + acc.double()).float()


def rotate(c, s, x, y):
    """rot(angle) @ (x, y) with rot = [[c, -s], [s, c]], as the JAX matmul
    computes it: (c*x + (-s)*y, s*x + c*y), each a `dot2`."""
    return dot2(c, x, -s, y), dot2(s, x, c, y)


def rotate_rows(x, y, c, s):
    """(x, y) @ rot.T for body-frame rows (x, y): the JAX `v @ rot.T`."""
    return dot2(x, c, y, -s), dot2(x, s, y, c)


def step(car: CarState, friction_limit: torch.Tensor,
         dt: float = C.DT) -> CarState:
    """One physics tick, `Car.step(dt)` + `world.Step(dt, ...)`, for B cars.

    friction_limit: (B, 4) per-wheel tire force limit (on-road
    FRICTION_LIMIT, grass 0.6x, car_dynamics.py:235-241)."""
    dev = car.angle.device
    dt = const(dt, dev)
    steer_err = car.steer - car.joint_angle
    motor_speed = torch.sign(steer_err) * (
        C.STEER_RATE_GAIN * steer_err.abs()).clamp(max=C.STEER_RATE_MAX)

    # wheel kinematics: world directions and contact-point velocity
    wheel_world_angle = car.angle[:, None] + car.joint_angle      # (B, 4)
    cos_w, sin_w = torch.cos(wheel_world_angle), torch.sin(wheel_world_angle)
    forw_x, forw_y = -sin_w, cos_w
    side_x, side_y = cos_w, sin_w

    c, s = torch.cos(car.angle), torch.sin(car.angle)
    com_x, com_y = (float(v) for v in np.float32(C.COM_BODY))
    cx, cy = rotate(c, s, com_x, com_y)
    com_wx = car.pos[:, 0] + cx
    com_wy = car.pos[:, 1] + cy
    wp = wheel_positions(dev)                                     # (4, 2)
    # WHEEL_POSITIONS @ rot.T
    wx, wy = rotate_rows(wp[:, 0], wp[:, 1], c[:, None], s[:, None])
    wheel_x = car.pos[:, 0:1] + wx
    wheel_y = car.pos[:, 1:2] + wy
    r_x = wheel_x - com_wx[:, None]
    r_y = wheel_y - com_wy[:, None]
    av = car.angular_vel[:, None]
    vw_x = car.vel[:, 0:1] + av * (-r_y)
    vw_y = car.vel[:, 1:2] + av * r_x
    vf = forw_x * vw_x + forw_y * vw_y
    vs = side_x * vw_x + side_y * vw_y

    # engine (:255-262)
    omega = car.omega + div(dt * C.ENGINE_POWER * car.gas,
                            C.WHEEL_MOMENT_OF_INERTIA) / (
        car.omega.abs() + C.ENGINE_OMEGA_BIAS)
    fuel_spent = car.fuel_spent + dt * C.ENGINE_POWER * car.gas.sum(-1)

    # brake (:264-272): >= 0.9 locks the wheel, else rate-limited decay
    val = torch.minimum(C.BRAKE_FORCE * car.brake, omega.abs())
    omega_braked = omega - torch.sign(omega) * val
    zero = torch.zeros_like(omega)
    omega = torch.where(car.brake >= 0.9, zero,
                        torch.where(car.brake > 0.0, omega_braked, omega))
    phase = car.phase + omega * dt

    # slip forces clamped to the friction circle (:275-311)
    vr = omega * C.WHEEL_RAD
    f_force = (-vf + vr) * C.SLIP_FORCE_COEF
    p_force = -vs * C.SLIP_FORCE_COEF
    force = sqrt(f_force * f_force + p_force * p_force)
    one = torch.ones_like(force)
    scale = torch.where(force > friction_limit,
                        friction_limit / force.clamp(min=1e-9), one)
    f_force = f_force * scale
    p_force = p_force * scale
    omega = omega - div(dt * f_force * C.WHEEL_RAD, C.WHEEL_MOMENT_OF_INERTIA)

    # assembly wrench, integrated (world.Step)
    fw_x = p_force * side_x + f_force * forw_x
    fw_y = p_force * side_y + f_force * forw_y
    f_total = torch.stack([_sum4(fw_x), _sum4(fw_y)], -1)          # (B, 2)
    torque = _sum4(r_x * fw_y - r_y * fw_x)
    vel = car.vel + div(dt * f_total, C.TOTAL_MASS)
    angular_vel = car.angular_vel + div(dt * torque, C.TOTAL_I)

    # Box2D's per-step motion clamps keep the scaled-back velocity
    translation = sqrt(vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1]) * dt
    b1 = torch.ones_like(translation)
    vel = vel * torch.where(
        translation > C.MAX_TRANSLATION,
        rdiv(C.MAX_TRANSLATION, translation.clamp(min=1e-9)), b1)[:, None]
    rotation = angular_vel.abs() * dt
    angular_vel = angular_vel * torch.where(
        rotation > C.MAX_ROTATION,
        rdiv(C.MAX_ROTATION, rotation.clamp(min=1e-9)), b1)

    com_nx = com_wx + dt * vel[:, 0]
    com_ny = com_wy + dt * vel[:, 1]
    angle = car.angle + dt * angular_vel
    rx, ry = rotate(torch.cos(angle), torch.sin(angle), com_x, com_y)
    pos = torch.stack([com_nx - rx, com_ny - ry], -1)

    joint_angle = (car.joint_angle + motor_speed * dt).clamp(
        -C.JOINT_LIMIT, C.JOINT_LIMIT)
    return CarState(pos=pos, angle=angle, vel=vel, angular_vel=angular_vel,
                    gas=car.gas, brake=car.brake, steer=car.steer,
                    joint_angle=joint_angle, phase=phase, omega=omega,
                    fuel_spent=fuel_spent)


def _sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum over the wheel axis, left to right."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


def hull_com_velocity(car: CarState) -> torch.Tensor:
    """(B, 2) velocity of the hull's own COM (`car.hull.linearVelocity`,
    car_racing.py:479)."""
    c, s = torch.cos(car.angle), torch.sin(car.angle)
    hx, hy = rotate(c, s, *(float(v) for v in np.float32(C.HULL_COM)))
    cx, cy = rotate(c, s, *(float(v) for v in np.float32(C.COM_BODY)))
    r_x = (car.pos[:, 0] + hx) - (car.pos[:, 0] + cx)
    r_y = (car.pos[:, 1] + hy) - (car.pos[:, 1] + cy)
    return torch.stack([car.vel[:, 0] + car.angular_vel * (-r_y),
                        car.vel[:, 1] + car.angular_vel * r_x], -1)


def save_state(car: CarState) -> torch.Tensor:
    """(B, 30) in the reference `_save_state` order (car_dynamics.py:138-178):
    6 hull scalars, then per wheel [wheel_rad, gas, brake, steer, phase,
    omega]."""
    hull_v = hull_com_velocity(car)
    wheels = torch.stack([torch.full_like(car.gas, C.WHEEL_RAD), car.gas,
                          car.brake, car.steer, car.phase, car.omega], -1)
    head = torch.stack([car.pos[:, 0], car.pos[:, 1], car.angle,
                        hull_v[:, 0], hull_v[:, 1], car.angular_vel], -1)
    return torch.cat([head, wheels.reshape(-1, 24)], -1)


def restore_state(saved: torch.Tensor) -> CarState:
    """Inverse of `save_state` (reference `_restore_state`,
    car_dynamics.py:180-196); joint angles reset to the steer targets."""
    saved = saved.to(F32)
    wheels = saved[:, 6:].reshape(-1, 4, 6)
    front = _wheel_mask([1.0, 1.0, 0.0, 0.0], saved)
    return CarState(
        pos=saved[:, 0:2].clone(), angle=saved[:, 2].clone(),
        vel=saved[:, 3:5].clone(), angular_vel=saved[:, 5].clone(),
        gas=wheels[:, :, 1].clone(), brake=wheels[:, :, 2].clone(),
        steer=wheels[:, :, 3].clone(),
        joint_angle=wheels[:, :, 3] * front, phase=wheels[:, :, 4].clone(),
        omega=wheels[:, :, 5].clone(),
        fuel_spent=torch.zeros_like(saved[:, 0]))


def stack_states(cars) -> CarState:
    """One batched CarState from a sequence of them (concatenated on B)."""
    return CarState(*(torch.cat(f, 0) for f in zip(*cars)))


class _StatesUnpickler(pickle.Unpickler):
    """Reads a pickle of the JAX package's `CarState` without importing that
    package: its class name maps to this module's `CarState`, numpy's array
    reconstructors are allowed, and every other global is refused."""

    _CAR = ("state_policy_diffusionmodel_tpu.physics.car", "CarState")

    def find_class(self, module, name):
        if (module, name) == self._CAR:
            return CarState
        if name in ("ndarray", "dtype") and module == "numpy":
            return getattr(np, name)
        if name == "_reconstruct" and module in ("numpy._core.multiarray",
                                                 "numpy.core.multiarray"):
            return np.ndarray.__reduce__(np.zeros(0))[0]
        raise pickle.UnpicklingError(f"global {module}.{name} is not allowed")


def load_pickled_states(path, device="cuda") -> list[CarState]:
    """The car states of a pickled list of single-car JAX `CarState`s (the
    golden-frame fixture), each as a batch of one on `device`."""
    from .. import resolve_device

    dev = resolve_device(device)
    with open(path, "rb") as f:
        cars = _StatesUnpickler(f).load()
    return [CarState(*(torch.from_numpy(np.asarray(v, np.float32))
                       .reshape((1,) + np.shape(v)).to(dev) for v in car))
            for car in cars]
