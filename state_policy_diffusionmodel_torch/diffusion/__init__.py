from . import schedules
from .closed_loop import (
    env_policy, env_policy_fn, init_ring_carry, keyed_init_noise,
    make_obs_normalizers, make_ring_policy,
)
from .policy import DiffusionPolicy, PolicyConfig
from .schedules import (
    DiffusionSchedule, add_noise, cosine_betas, ddim_step, ddim_timesteps,
    ddpm_step, dpmpp_2m_step, linear_betas, linear_betas_v2, make_schedule,
)

__all__ = [
    "schedules", "DiffusionPolicy", "PolicyConfig", "DiffusionSchedule",
    "make_schedule", "add_noise", "ddpm_step", "ddim_step", "dpmpp_2m_step",
    "ddim_timesteps", "linear_betas", "linear_betas_v2", "cosine_betas",
    "make_ring_policy", "init_ring_carry", "make_obs_normalizers",
    "env_policy", "env_policy_fn", "keyed_init_noise",
]
