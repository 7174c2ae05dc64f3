"""Read a trained run directory: params.npz, hparams.yaml and STATS.pkl.

Counterpart of the reading half of
`state_policy_diffusionmodel_tpu/train/checkpoints.py` plus
`data/dataset.py::load_stats`. A run directory holds
`checkpoints/epoch=K/params.npz` (keystr leaves, possibly float16), a flat
`hparams.yaml` of `key: value` lines and the `STATS.pkl` normalization
sidecar. The yaml is parsed here, so no yaml package is needed.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Any, Dict, Optional

from .. import resolve_device
from ..diffusion.policy import DiffusionPolicy, PolicyConfig
from ..models import MODEL_REGISTRY
from ..params_from_jax import load_npz, params_from_jax

_CONFIG_KEYS = ("noise_steps", "obs_horizon", "pred_horizon",
                "inpaint_horizon", "prediction_dim", "model",
                "noise_scheduler_type", "step_size", "time_dim",
                "vision_encoder", "vision_latent", "uniform_init",
                "model_width")


def checkpoint_dir(out_dir: str, epoch: int,
                   subdir: str = "checkpoints") -> str:
    return os.path.join(out_dir, subdir, f"epoch={epoch}")


def latest_checkpoint(out_dir: str,
                      subdir: str = "checkpoints") -> Optional[str]:
    root = os.path.join(out_dir, subdir)
    if not os.path.isdir(root):
        return None
    epochs = []
    for name in os.listdir(root):
        if name.startswith("epoch="):
            try:
                epochs.append(int(name.split("=")[1]))
            except ValueError:
                pass
    if not epochs:
        return None
    return checkpoint_dir(out_dir, max(epochs), subdir)


_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _scalar(text: str) -> Any:
    if text in ("null", "~", ""):
        return None
    if text in ("true", "false"):
        return text == "true"
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def load_hparams(path: str) -> Dict[str, Any]:
    """Parse a flat `key: value` hparams.yaml (null, true/false, ints,
    floats such as 1.0e-06, strings); anything nested raises."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if line[0].isspace() or ":" not in line:
                raise ValueError(f"{path}:{n}: not a flat `key: value` line")
            key, _, value = line.partition(":")
            out[key.strip()] = _scalar(value.strip())
    return out


def load_stats(path: str) -> dict:
    """The normalization stats: the first entry of the pickled list."""
    with open(path, "rb") as f:
        return pickle.load(f)[0]


def ema_subdir(run_dir: str) -> str:
    """Where a run keeps its EMA weights: `checkpoints_ema/` (the trainer's
    layout), or `checkpoints/` of an exported best run whose BEST.json
    says its weights are the EMA ones."""
    if os.path.isdir(os.path.join(run_dir, "checkpoints_ema")):
        return "checkpoints_ema"
    best = os.path.join(run_dir, "BEST.json")
    if os.path.exists(best):
        with open(best) as f:
            if json.load(f).get("ema"):
                return "checkpoints"
    raise FileNotFoundError(f"{run_dir} holds no EMA weights")


def load_run(run_dir: str, device="cuda", ema: bool = False):
    """(policy, params, stats) for a trained run, assembled as the JAX
    package's run_predictions does: the config from hparams.yaml, the
    newest epoch's params (the EMA weights with `ema`), and STATS.pkl."""
    dev = resolve_device(device)
    hp = load_hparams(os.path.join(run_dir, "hparams.yaml"))
    cfg = PolicyConfig(**{k: hp[k] for k in _CONFIG_KEYS if k in hp})
    subdir = ema_subdir(run_dir) if ema else "checkpoints"
    ckpt = latest_checkpoint(run_dir, subdir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/{subdir}")
    params = params_from_jax(load_npz(os.path.join(ckpt, "params.npz")), dev)
    unet = params["unet"]
    if cfg.model not in MODEL_REGISTRY:
        raise NotImplementedError(f"model {cfg.model!r} is not ported")
    want = (64 if cfg.model_width is None else cfg.model_width, cfg.time_dim,
            MODEL_REGISTRY[cfg.model]["with_attention"], cfg.has_encoder)
    got = (unet.width, unet.time_dim, unet.with_attention, "encoder" in params)
    if got != want:
        raise ValueError(f"{ckpt} does not match hparams.yaml: (width, "
                         f"time_dim, attention, encoder) {got} vs {want}")
    stats = load_stats(os.path.join(run_dir, "STATS.pkl"))
    return DiffusionPolicy(cfg, dev), params, stats
