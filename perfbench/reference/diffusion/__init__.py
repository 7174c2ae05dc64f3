from . import schedules
from .closed_loop import (
    init_ring_carry, keyed_init_noise, make_obs_normalizers, make_ring_policy,
)
from .policy import DiffusionPolicy, PolicyConfig

__all__ = ["schedules", "DiffusionPolicy", "PolicyConfig",
           "make_ring_policy", "init_ring_carry", "make_obs_normalizers",
           "keyed_init_noise"]
