"""Run directories: params.npz checkpoints, hparams.yaml, STATS.pkl and the
trainer's resume sidecar, read and written without yaml or orbax.

Counterpart of `state_policy_diffusionmodel_tpu/train/checkpoints.py` plus
`data/dataset.py::load_stats`. A run directory holds
`checkpoints/epoch=K/params.npz` (keystr leaves in the flax layout, possibly
float16), `checkpoints_ema/` alike, a flat `hparams.yaml` of `key: value`
lines, the `STATS.pkl` normalization sidecar and
`trainer_state/{opt/params.npz, meta.yaml}`. The JAX package writes the
npz form when orbax is absent (as on the GPU machine) and reads it always,
so run directories load in both directions. The yaml is parsed and written
here, in the text `yaml.safe_dump` gives.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Optional

import numpy as np

from .. import resolve_device
from ..data.dataset import load_stats
from ..diffusion.policy import ENCODERS, DiffusionPolicy, PolicyConfig
from ..models import model_entry
from ..params_from_jax import (
    load_into, load_npz, params_from_jax, params_to_jax,
)

_CONFIG_KEYS = ("noise_steps", "obs_horizon", "pred_horizon",
                "inpaint_horizon", "prediction_dim", "model",
                "noise_scheduler_type", "step_size", "time_dim",
                "vision_encoder", "vision_latent", "uniform_init",
                "train_encoder", "model_width")


def checkpoint_dir(out_dir: str, epoch: int,
                   subdir: str = "checkpoints") -> str:
    return os.path.join(out_dir, subdir, f"epoch={epoch}")


def save_npz(path: str, leaves: Dict[str, np.ndarray],
             dtype=None) -> None:
    """{keystr: array} as an npz (floating leaves cast to `dtype` when
    given), written to a temporary name and renamed into place."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if dtype is not None:
        leaves = {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
                  else v for k, v in leaves.items()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **leaves)
    os.replace(tmp, path)


def save_checkpoint(out_dir: str, params, epoch: int,
                    subdir: str = "checkpoints") -> str:
    """`<out_dir>/<subdir>/epoch=K/params.npz` of the policy modules (or of
    {keystr: array} leaves already taken from them), in the JAX package's
    npz form."""
    path = checkpoint_dir(out_dir, epoch, subdir)
    leaves = params if _is_leaves(params) else params_to_jax(params)
    save_npz(os.path.join(path, "params.npz"), leaves)
    return path


def _is_leaves(tree) -> bool:
    return all(isinstance(v, np.ndarray) for v in tree.values())


def load_checkpoint(path: Optional[str], like):
    """Load `<path>/params.npz` into the policy modules `like` (in place, at
    their dtype; float16 stores are widened) and return them."""
    if path is None:
        raise FileNotFoundError(
            "no checkpoint found: if this was an --ema load, the run has "
            "no checkpoints_ema/ (trained without --ema_decay?)")
    tree = load_npz(os.path.join(path, "params.npz"))
    extra = sorted(set(tree) - set(like))
    if extra:
        raise ValueError(f"{path}: unexpected parameter trees {extra}")
    for name, module in like.items():
        dtype = next(module.parameters()).dtype
        load_into(module, tree[name])
        module.to(dtype)
    return like


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


_SPECIAL = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
            ".nan": math.nan}


def _scalar(text: str) -> Any:
    if text in ("null", "~", ""):
        return None
    if text in ("true", "false"):
        return text == "true"
    if text.lower() in _SPECIAL:
        return _SPECIAL[text.lower()]
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


_PLAIN = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./-]*$")
_RESERVED = {"null", "true", "false", "yes", "no", "on", "off", "y", "n",
             "~"}


def yaml_scalar(value: Any) -> str:
    """One value as `yaml.safe_dump` writes it: null, true/false, ints,
    floats by repr with `.0` put before a bare exponent (1.0e-06), .inf and
    .nan, strings plain where nothing else could read them as another type,
    else single-quoted."""
    if value is None:
        return "null"
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        v = float(value)
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    text = str(value)
    if (_PLAIN.match(text) and text.lower() not in _RESERVED
            and isinstance(_scalar(text), str)):
        return text
    return "'" + text.replace("'", "''") + "'"


def dump_flat_yaml(payload: Dict[str, Any], path: str) -> str:
    """A flat mapping as `yaml.safe_dump` writes it: sorted `key: value`
    lines."""
    with open(path, "w") as f:
        for k in sorted(payload):
            f.write(f"{k}: {yaml_scalar(payload[k])}\n")
    return path


def save_hparams(out_dir: str, policy_config, train_config=None) -> str:
    """hparams.yaml with the policy + train config, `train_`-prefixed, and
    `observation_dim` (the JAX package's `save_hparams`)."""
    payload: Dict[str, Any] = dict(dataclasses.asdict(policy_config))
    if train_config is not None:
        payload.update({f"train_{k}": v for k, v in
                        dataclasses.asdict(train_config).items()})
    payload.setdefault("observation_dim", policy_config.observation_dim)
    return dump_flat_yaml(payload, os.path.join(out_dir, "hparams.yaml"))


def save_train_state(out_dir: str, opt_leaves: Dict[str, np.ndarray],
                     meta: Dict[str, Any]) -> str:
    """The resume sidecar, latest only: the optimizer state as keystr
    leaves of optax's tree (`trainer_state/opt/params.npz`) and the host
    metadata (`trainer_state/meta.yaml`)."""
    path = os.path.join(out_dir, "trainer_state")
    save_npz(os.path.join(path, "opt", "params.npz"), opt_leaves)
    dump_flat_yaml(meta, os.path.join(path, "meta.yaml"))
    return path


def load_train_state(out_dir: str):
    """({keystr: array} optimizer leaves, meta) or None without a resume
    sidecar."""
    path = os.path.join(out_dir, "trainer_state")
    meta_path = os.path.join(path, "meta.yaml")
    if not os.path.exists(meta_path):
        return None
    with np.load(os.path.join(path, "opt", "params.npz")) as data:
        leaves = {k: np.asarray(data[k]) for k in data.files}
    return leaves, load_hparams(meta_path)


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


def load_run(run_dir: str, device="cuda", ema: bool = False,
             epoch: Optional[int] = None):
    """(policy, params, stats) for a trained run, assembled as the JAX
    package's run_predictions does: the config from hparams.yaml, the
    newest epoch's params (or `epoch`'s; the EMA weights with `ema`), and
    STATS.pkl."""
    dev = resolve_device(device)
    hp = load_hparams(os.path.join(run_dir, "hparams.yaml"))
    cfg = PolicyConfig(**{k: hp[k] for k in _CONFIG_KEYS if k in hp})
    subdir = ema_subdir(run_dir) if ema else "checkpoints"
    if epoch is None:
        ckpt = latest_checkpoint(run_dir, subdir)
    else:
        ckpt = checkpoint_dir(run_dir, epoch, subdir)
        ckpt = ckpt if os.path.isdir(ckpt) else None
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint under {run_dir}/{subdir}"
            + ("" if epoch is None else f" for epoch {epoch}"))
    params = params_from_jax(load_npz(os.path.join(ckpt, "params.npz")), dev)
    cls, kw, default_width = model_entry(cfg.model)
    unet, enc = params["unet"], params.get("encoder")
    want = (cls.__name__, default_width if cfg.model_width is None
            else cfg.model_width, cfg.time_dim, kw.get("with_attention"),
            ENCODERS[cfg.vision_encoder].__name__ if cfg.has_encoder
            else None)
    got = (type(unet).__name__, unet.width, unet.time_dim,
           getattr(unet, "with_attention", None),
           None if enc is None else type(enc).__name__)
    if got != want:
        raise ValueError(f"{ckpt} does not match hparams.yaml: (net, width, "
                         f"time_dim, attention, encoder) {got} vs {want}")
    stats = load_stats(os.path.join(run_dir, "STATS.pkl"))
    return DiffusionPolicy(cfg, dev), params, stats
