"""Closed-loop ring policy: observations in, actions out, one frame at a time.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/closed_loop.py`,
with the same semantics: rolling raw-frame rings of obs_horizon*step_size
frames, subsampled every step_size frames (newest-aligned) at denoise time;
a denoise when the frame counter is a multiple of step_size; the action
queue's row 0 executed in between; the executed action rolled into the
action ring after the selection.

The policy takes the observation explicitly, `(obs uint8 (B, 96, 96, 3),
car_position (B, 2), car_velocity (B, 2))`, in place of an env result.
x_T at each denoise is `keyed_init_noise`: each env's x_T is row `uid` of
a CPU generator's uniform stream seeded by (seed, k0), as the JAX policy
keys its threefry draw per global env id. torch cannot reproduce
threefry, so the numbers differ from JAX's; the property holds. The
sampler is DDIM in float32, the one the cells run.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .policy import DiffusionPolicy


def make_obs_normalizers(stats, device="cuda"):
    """(norm_batch, unnorm_actions) closures for a closed-loop rollout.

    norm_batch maps a window of RAW values {image_features?, position,
    velocity, action} (each (B, T_obs, ...)) to the training normalization:
    min-max velocity and action to [-1, 1], position min-max then centred on
    the window's first frame and halved. unnorm_actions maps normalized
    actions back to env units."""
    device = resolve_device(device)
    pmin = float(np.min(stats["position"]["min"]))
    pmax = float(np.max(stats["position"]["max"]))
    prng = (pmax - pmin) or 1.0

    def vec(lo, hi):
        lo = np.asarray(lo, np.float32)
        rng = np.asarray(hi, np.float32) - lo
        rng = np.where(rng == 0, 1.0, rng).astype(np.float32)
        return (torch.from_numpy(lo).to(device),
                torch.from_numpy(rng).to(device))

    vlo, vrng = vec(stats["velocity"]["min"], stats["velocity"]["max"])
    alo, arng = vec(stats["action"]["min"], stats["action"]["max"])

    def norm_batch(hist):
        sn = (hist["position"] - pmin) / prng * 2.0 - 1.0
        out = {
            "position": (sn - sn[:, 0:1]) / 2.0,
            "velocity": (hist["velocity"] - vlo) / vrng * 2.0 - 1.0,
            "action": (hist["action"] - alo) / arng * 2.0 - 1.0,
        }
        if "image_features" in hist:
            out["image_features"] = hist["image_features"]
        return out

    def unnorm_actions(a):
        return (a + 1.0) / 2.0 * arng + alo

    return norm_batch, unnorm_actions


def init_ring_carry(policy: DiffusionPolicy, n_envs: int):
    """Per-env carry: raw-frame observation rings of obs_horizon*step_size
    frames, the committed action queue, the env ids that key x_T, and the
    frame counter `k`. All envs step together, so
    `k` is one Python int (the JAX carry's k[0]): reading it never waits
    for the device."""
    cfg = policy.config
    L = cfg.obs_horizon * cfg.step_size
    dev = policy.device
    hist = {
        "position": torch.zeros((n_envs, L, 2), device=dev),
        "velocity": torch.zeros((n_envs, L, 2), device=dev),
        "action": torch.zeros((n_envs, L, 3), device=dev),
    }
    if cfg.has_encoder:
        hist["image_features"] = torch.zeros(
            (n_envs, L, cfg.feature_dim), device=dev)
    return {
        "hist": hist,
        "queue": torch.zeros((n_envs, cfg.pred_horizon, 3), device=dev),
        "k": 0,
        "uid": torch.arange(n_envs, device=dev),
    }


def keyed_init_noise(uid, k0: int, shape, seed: int = 0) -> np.ndarray:
    """(B, *shape) float32 uniform x_T, row b a function of (seed, uid[b],
    k0) only.

    The draw of env u at frame k0 is row u of the uniform stream of a CPU
    `torch.Generator` seeded seed * 1_000_003 + k0, `size` numbers a row.
    The CPU generator fills a tensor element by element in order, so a row
    depends on its index and not on how many rows are drawn: one draw of
    max(uid) + 1 rows, indexed by uid, gives every env its own x_T
    whatever else is in the batch."""
    uid = np.asarray(uid, np.int64)
    if uid.size and uid.min() < 0:
        raise ValueError(f"env ids must be >= 0, got {uid.min()}")
    size = int(np.prod(shape))
    gen = torch.Generator().manual_seed(seed * 1_000_003 + k0)
    rows = int(uid.max()) + 1 if uid.size else 0
    u = torch.rand((rows, size), generator=gen).numpy()[uid]
    return u.reshape((len(uid),) + tuple(shape))


def make_ring_policy(policy: DiffusionPolicy, stats,
                     num_inference_steps: int = 10,
                     seed: int = 0) -> Callable:
    """policy_fn(params, carry, obs, car_position, car_velocity)
    -> ((B, 3) actions, carry).

    A DDIM denoise every step_size frames from x_T = `keyed_init_noise(uid,
    k0, ..., seed)`, keyed per global env id (`uid`); the queue's row 0
    executed in between."""
    cfg = policy.config
    if not cfg.uniform_init:
        raise ValueError("the reference draws a uniform x_T only")
    dev = policy.device
    L = cfg.obs_horizon * cfg.step_size
    norm_batch, unnorm_actions = make_obs_normalizers(stats, dev)
    sub_idx = torch.arange(cfg.step_size - 1, L, cfg.step_size, device=dev)

    def roll(h, new):
        return torch.cat([h[:, 1:], new[:, None].to(h.dtype)], dim=1)

    @torch.no_grad()
    def policy_fn(params, carry, obs, car_position, car_velocity):
        hist, queue = dict(carry["hist"]), carry["queue"]
        k0, uid = carry["k"], carry["uid"]

        hist["position"] = roll(hist["position"], car_position)
        hist["velocity"] = roll(hist["velocity"], car_velocity)
        if "image_features" in hist:
            frame = (obs.float() / 255.0)[:, None]
            feats = policy.encode_images(params, frame)
            hist["image_features"] = roll(hist["image_features"],
                                          feats[:, 0].float())

        if k0 % cfg.step_size == 0:
            window = norm_batch({name: v[:, sub_idx]
                                 for name, v in hist.items()})
            x_T = torch.from_numpy(keyed_init_noise(
                uid.cpu().numpy(), k0, (cfg.horizon, cfg.prediction_dim),
                seed)).to(dev)
            out = policy.sample(params, window, x_T, num_inference_steps)
            queue = unnorm_actions(out[:, cfg.inpaint_horizon:, 2:5])

        actions = queue[:, 0]
        hist["action"] = roll(hist["action"], actions)
        return actions, {"hist": hist, "queue": queue, "k": k0 + 1,
                         "uid": uid}

    return policy_fn
