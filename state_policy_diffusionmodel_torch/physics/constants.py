"""Physical constants of the top-down car, matching the reference dynamics.

The reference (`envs/car_dynamics.py:23-47`) builds a 5-body
Box2D assembly: a hull (4 convex polygon fixtures, density 1.0) plus 4 wheel
bodies (density 0.1) attached with revolute joints. Because the road tiles are
*sensors* (`envs/car_racing.py:356`) there are never contact
impulses, so the assembly moves as a single rigid body driven purely by the
analytic tire forces of `Car.step` — which is what we model here directly.

This module computes the Box2D-equivalent mass, center of mass and moment of
inertia of that rigid assembly from the same polygon definitions, so the
batched PyTorch integrator in `car.py` reproduces the reference accelerations.
A copy of `state_policy_diffusionmodel_tpu/physics/constants.py`.
"""

from __future__ import annotations

import numpy as np

# --- raw constants (reference car_dynamics.py:23-47) ---
SIZE = 0.02
ENGINE_POWER = 100_000_000 * SIZE * SIZE          # 4e4
WHEEL_MOMENT_OF_INERTIA = 4000 * SIZE * SIZE      # 1.6
FRICTION_LIMIT = 1_000_000 * SIZE * SIZE          # 400
WHEEL_R = 27
WHEEL_W = 14
WHEELPOS = np.array([(-55, +80), (+55, +80), (-55, -82), (+55, -82)], np.float64)
HULL_POLY1 = [(-60, +130), (+60, +130), (+60, +110), (-60, +110)]
HULL_POLY2 = [(-15, +120), (+15, +120), (+20, +20), (-20, 20)]
HULL_POLY3 = [
    (+25, +20), (+50, -10), (+50, -40), (+20, -90),
    (-20, -90), (-50, -40), (-50, -10), (-25, +20),
]
HULL_POLY4 = [(-50, -120), (+50, -120), (+50, -90), (-50, -90)]

HULL_DENSITY = 1.0
WHEEL_DENSITY = 0.1

# slip-force gain, brake rate, steering servo (car_dynamics.py:232,267,283)
SLIP_FORCE_COEF = 205_000 * SIZE * SIZE           # 82
BRAKE_FORCE = 15.0                                # rad/s per unit brake
STEER_RATE_GAIN = 50.0
STEER_RATE_MAX = 3.0
JOINT_LIMIT = 0.4                                 # revolute joint angle limits
GAS_RAMP = 0.1                                    # max gas increase per call
GRASS_FRICTION = 0.6                              # friction scale off-road
ENGINE_OMEGA_BIAS = 5.0                           # |omega|+5 in engine term

WHEEL_RAD = WHEEL_R * SIZE                        # 0.54
WHEEL_POSITIONS = WHEELPOS * SIZE                 # body-frame anchor points (4,2)

DT = 1.0 / 50.0                                   # env tick (car_racing.py:455)

# Box2D solver motion clamps (b2Settings.h): per-step translation is capped
# at 2 units and rotation at pi/2 rad; the scaled-back velocity is KEPT, so
# they act as hard speed caps (100 u/s, 78.5 rad/s at dt=1/50). The
# reference car hits the translation cap at full throttle (world.Step,
# car_racing.py:456).
MAX_TRANSLATION = 2.0
MAX_ROTATION = np.pi / 2


def _polygon_mass_properties(verts, density):
    """Area, centroid and inertia (about centroid) of a simple CCW polygon.

    Same math Box2D uses in b2PolygonShape::ComputeMass.
    """
    v = np.asarray(verts, np.float64)
    # normalize to CCW winding (the reference polys are listed clockwise;
    # Box2D normalizes internally)
    if 0.5 * np.sum(v[:, 0] * np.roll(v[:, 1], -1) - np.roll(v[:, 0], -1) * v[:, 1]) < 0:
        v = v[::-1]
    x, y = v[:, 0], v[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    area = 0.5 * np.sum(cross)
    cx = np.sum((x + x1) * cross) / (6.0 * area)
    cy = np.sum((y + y1) * cross) / (6.0 * area)
    # inertia about the origin
    i_origin = density * np.sum(cross * (x * x + x * x1 + x1 * x1
                                         + y * y + y * y1 + y1 * y1)) / 12.0
    mass = density * area
    i_com = i_origin - mass * (cx * cx + cy * cy)
    return mass, np.array([cx, cy]), i_com


def _combine(parts):
    """Combine (mass, com, I_com) fixtures into one rigid body."""
    m_total = sum(m for m, _, _ in parts)
    com = sum(m * c for m, c, _ in parts) / m_total
    inertia = sum(i + m * np.sum((c - com) ** 2) for m, c, i in parts)
    return m_total, com, inertia


def _scaled(poly):
    return [(x * SIZE, y * SIZE) for x, y in poly]


_hull_parts = [
    _polygon_mass_properties(_scaled(p), HULL_DENSITY)
    for p in (HULL_POLY1, HULL_POLY2, HULL_POLY3, HULL_POLY4)
]
HULL_MASS, HULL_COM, HULL_I = _combine(_hull_parts)

_wheel_poly = [
    (-WHEEL_W * SIZE, +WHEEL_R * SIZE),
    (+WHEEL_W * SIZE, +WHEEL_R * SIZE),
    (+WHEEL_W * SIZE, -WHEEL_R * SIZE),
    (-WHEEL_W * SIZE, -WHEEL_R * SIZE),
][::-1]  # CCW order
WHEEL_MASS, _, WHEEL_I = _polygon_mass_properties(_wheel_poly, WHEEL_DENSITY)

# the rigid assembly: hull + 4 wheels at their anchors.  Inertia of a planar
# lamina about the z-axis through its COM is rotation-invariant, so steering
# does not change the assembly inertia.
_assembly_parts = [(HULL_MASS, HULL_COM, HULL_I)] + [
    (WHEEL_MASS, WHEEL_POSITIONS[i], WHEEL_I) for i in range(4)
]
TOTAL_MASS, COM_BODY, TOTAL_I = _combine(_assembly_parts)

__all__ = [
    "SIZE", "ENGINE_POWER", "WHEEL_MOMENT_OF_INERTIA", "FRICTION_LIMIT",
    "WHEEL_R", "WHEEL_W", "WHEELPOS", "WHEEL_RAD", "WHEEL_POSITIONS",
    "HULL_POLY1", "HULL_POLY2", "HULL_POLY3", "HULL_POLY4",
    "SLIP_FORCE_COEF", "BRAKE_FORCE", "STEER_RATE_GAIN", "STEER_RATE_MAX",
    "JOINT_LIMIT", "GAS_RAMP", "GRASS_FRICTION", "ENGINE_OMEGA_BIAS",
    "HULL_MASS", "HULL_COM", "HULL_I", "WHEEL_MASS", "WHEEL_I",
    "TOTAL_MASS", "COM_BODY", "TOTAL_I", "DT",
]
