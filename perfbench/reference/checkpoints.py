"""A trained run's weights and statistics for the reference, read from the
run directory's files: `checkpoints/epoch=<n>/params.npz` (the flax
parameter tree by keystr) and `STATS.pkl`. The sizes come from the
benchmark's configuration file, not from the run's hparams.yaml."""

from __future__ import annotations

import os
import pickle

from .diffusion.policy import DiffusionPolicy, PolicyConfig
from .params_from_jax import load_npz, params_from_jax

CONFIG_KEYS = ("noise_steps", "obs_horizon", "pred_horizon",
               "inpaint_horizon", "prediction_dim", "model",
               "noise_scheduler_type", "step_size", "time_dim",
               "vision_encoder", "vision_latent", "uniform_init",
               "train_encoder", "model_width")


def policy_config(config: dict) -> PolicyConfig:
    return PolicyConfig(**{k: config[k] for k in CONFIG_KEYS if k in config})


def load_weights(root: str, config: dict, device):
    """(policy, params, stats) of the configuration's run and epoch."""
    run = os.path.join(root, config["run_dir"])
    npz = os.path.join(run, "checkpoints", f"epoch={config['epoch']}",
                       "params.npz")
    params = params_from_jax(load_npz(npz), device)
    with open(os.path.join(run, "STATS.pkl"), "rb") as f:
        stats = pickle.load(f)[0]
    return (DiffusionPolicy(policy_config(config["policy"]), device), params,
            stats)
