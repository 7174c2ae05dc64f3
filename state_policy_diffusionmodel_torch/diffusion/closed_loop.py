"""Closed-loop ring policy: observations in, actions out, one frame at a time.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/closed_loop.py`,
with the same semantics: rolling raw-frame rings of obs_horizon*step_size
frames, subsampled every step_size frames (newest-aligned) at denoise time;
a denoise when the frame counter is a multiple of step_size; the action
queue's row 0 executed in between; the executed action rolled into the
action ring after the selection.

The policy takes the observation explicitly, `(obs uint8 (B, 96, 96, 3),
car_position (B, 2), car_velocity (B, 2))`, in place of an env result.
x_T at each denoise is `init_noise_fn(uid, k0)`; the default draws it from
a CPU `torch.Generator` seeded by (seed, k0) and moves it to the device,
so a rerun of the same rollout sees the same x_T on any device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from .policy import DiffusionPolicy, cast_params


def make_obs_normalizers(stats, device="cuda"):
    """(norm_batch, unnorm_actions) closures for a closed-loop rollout.

    norm_batch maps a window of RAW values {image_features?, position,
    velocity, action} (each (B, T_obs, ...)) to the training normalization:
    min-max velocity and action to [-1, 1], position min-max then centred on
    the window's first frame and halved. unnorm_actions maps normalized
    actions back to env units. stats=None -> identity."""
    device = resolve_device(device)
    if stats is None:
        return (lambda hist: hist), (lambda a: a)
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


def init_ring_carry(policy: DiffusionPolicy, n_envs: int,
                    env_uids: Optional[torch.Tensor] = None):
    """Per-env carry: raw-frame observation rings of obs_horizon*step_size
    frames, the committed action queue, the env ids handed to
    init_noise_fn, and the frame counter `k`. All envs step together, so
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
            (n_envs, L, cfg.observation_dim - cfg.state_cond_dim), device=dev)
    return {
        "hist": hist,
        "queue": torch.zeros((n_envs, cfg.pred_horizon, 3), device=dev),
        "k": 0,
        "uid": (torch.arange(n_envs, device=dev) if env_uids is None
                else env_uids.to(dev)),
    }


# straight ahead at 0.3 gas: the warm-up action of the JAX bench.py's
# driving metrics
WARMUP_ACTION = (0.0, 0.3, 0.0)


def make_ring_policy(policy: DiffusionPolicy, stats=None,
                     sampler: str = "ddim", num_inference_steps: int = 10,
                     ddim_spacing: str = "leading", amp: bool = False,
                     init_noise_fn: Optional[Callable] = None,
                     seed: int = 0, warmup: int = 0,
                     denoise_microbatches: int = 1) -> Callable:
    """policy_fn(params, carry, obs, car_position, car_velocity)
    -> ((B, 3) actions, carry).

    init_noise_fn(uid, k0) -> (B, horizon, prediction_dim) x_T for the
    denoise at frame k0; by default a draw from a CPU generator seeded by
    seed * 1_000_003 + k0. The ddpm sampler also draws its per-step noise
    from that generator.

    warmup > 0 drives WARMUP_ACTION for the first `warmup` frames, with
    no denoise, while the rings fill with real observations (the driving
    metrics of the JAX bench.py use warmup = obs_horizon * step_size).
    denoise_microbatches = M splits each denoise into M sampler calls over
    slices of the batch, with the slices of one x_T draw."""
    cfg = policy.config
    dev = policy.device
    L = cfg.obs_horizon * cfg.step_size
    norm_batch, unnorm_actions = make_obs_normalizers(stats, dev)
    sub_idx = torch.arange(cfg.step_size - 1, L, cfg.step_size, device=dev)
    warm_action = torch.tensor(WARMUP_ACTION, dtype=torch.float32).to(dev)
    cast_cache: dict = {}

    def generator(k0: int) -> torch.Generator:
        # on the CPU: the same numbers whatever device the policy runs on
        return torch.Generator().manual_seed(seed * 1_000_003 + k0)

    def amp_params(params):
        # cast once per params dict; keeping the dict alive keeps its id
        if cast_cache.get("src") is not params:
            cast_cache["src"] = params
            cast_cache["bf16"] = cast_params(params, torch.bfloat16)
        return cast_cache["bf16"]

    def roll(h, new):
        return torch.cat([h[:, 1:], new[:, None].to(h.dtype)], dim=1)

    @torch.no_grad()
    def policy_fn(params, carry, obs, car_position, car_velocity):
        hist, queue = dict(carry["hist"]), carry["queue"]
        k0, uid = carry["k"], carry["uid"]
        if amp:
            params = amp_params(params)

        hist["position"] = roll(hist["position"], car_position)
        hist["velocity"] = roll(hist["velocity"], car_velocity)
        if "image_features" in hist:
            frame = (obs.float() / 255.0)[:, None]
            if amp:
                frame = frame.to(torch.bfloat16)
            feats = policy.encode_images(params, frame)
            hist["image_features"] = roll(hist["image_features"],
                                          feats[:, 0].float())

        if k0 % cfg.step_size == 0 and k0 >= warmup:
            window = norm_batch({name: v[:, sub_idx]
                                 for name, v in hist.items()})
            gen = generator(k0)
            B = uid.shape[0]
            x_T = (policy.init_noise(B, gen)
                   if init_noise_fn is None else init_noise_fn(uid, k0))
            chunk = -(-B // denoise_microbatches)
            outs = [policy.sample(
                params, {name: v[i:i + chunk] for name, v in window.items()},
                gen, sampler=sampler, num_inference_steps=num_inference_steps,
                amp=amp, ddim_spacing=ddim_spacing,
                init_noise=x_T[i:i + chunk]) for i in range(0, B, chunk)]
            queue = unnorm_actions(
                torch.cat(outs)[:, cfg.inpaint_horizon:, 2:5])

        if k0 < warmup:
            actions = warm_action.expand(queue.shape[0], 3)
        else:
            actions = queue[:, 0]
        hist["action"] = roll(hist["action"], actions)
        return actions, {"hist": hist, "queue": queue, "k": k0 + 1,
                         "uid": uid}

    return policy_fn


def env_policy(policy_fn: Callable, params) -> Callable:
    """Adapt a ring policy to `envs.vector.rollout_policy`: the returned
    policy(carry, states, prev_res) feeds policy_fn the previous step's
    frame, car position and hull velocity, as the JAX ring policy reads
    them from its `prev_res`."""

    def policy(carry, states, prev_res):
        del states
        return policy_fn(params, carry, prev_res.obs,
                         prev_res.info.car_position,
                         prev_res.info.car_velocity)

    return policy
