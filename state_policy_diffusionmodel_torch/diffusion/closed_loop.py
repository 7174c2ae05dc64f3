"""Closed-loop ring policy: observations in, actions out, one frame at a time.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/closed_loop.py`,
with the same semantics: rolling raw-frame rings of obs_horizon*step_size
frames, subsampled every step_size frames (newest-aligned) at denoise time;
a denoise when the frame counter is a multiple of step_size; the action
queue's row 0 executed in between; the executed action rolled into the
action ring after the selection.

The policy takes the observation explicitly, `(obs uint8 (B, 96, 96, 3),
car_position (B, 2), car_velocity (B, 2))`, in place of an env result.
x_T at each denoise is `init_noise_fn(uid, k0)`; the default,
`keyed_init_noise`, draws each env's x_T as row `uid` of a CPU generator's
stream seeded by (seed, k0), as the JAX policy keys its threefry draw per
global env id: an env gets the same x_T whatever else is in the batch, on
one rank or many, and on any device. torch cannot reproduce threefry, so
the numbers differ from JAX's; the property holds.
"""

from __future__ import annotations

import functools
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
            (n_envs, L, cfg.feature_dim), device=dev)
    return {
        "hist": hist,
        "queue": torch.zeros((n_envs, cfg.pred_horizon, 3), device=dev),
        "k": 0,
        "uid": (torch.arange(n_envs, device=dev) if env_uids is None
                else env_uids.to(dev)),
    }


def keyed_init_noise(uid, k0: int, shape, seed: int = 0,
                     uniform: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> np.ndarray:
    """(B, *shape) float32 x_T, row b a function of (seed, uid[b], k0) only.

    The draw of env u at frame k0 is row u of the uniform stream of a CPU
    `torch.Generator` seeded seed * 1_000_003 + k0, `size` numbers a row
    (2 * size for a normal). The CPU generator fills a tensor element by
    element in order, so a row depends on its index and not on how many
    rows are drawn: one draw of max(uid) + 1 rows, indexed by uid, gives
    every env its own x_T whatever else is in the batch. For uid =
    arange(B) and `uniform` it is the draw the ring policy took before it
    was keyed, `torch.rand((B, *shape), generator)`. A normal is Box-Muller
    in float64 over the row's pairs (1 - u1 in (0, 1], u2), rounded to
    float32: other samples than the unkeyed `torch.randn` drew. The cost
    grows with the largest id, not the batch: ids are the envs' global
    indices, so each rank draws the rows of the whole global batch up to
    its last env and keeps its own. `generator`, when given, is that
    freshly seeded generator, left after the draw (the ring policy's DDPM
    noise goes on from there, as it did after the unkeyed draw)."""
    uid = np.asarray(uid, np.int64)
    if uid.size and uid.min() < 0:
        raise ValueError(f"env ids must be >= 0, got {uid.min()}")
    size = int(np.prod(shape))
    n = size if uniform else 2 * size
    gen = (torch.Generator().manual_seed(seed * 1_000_003 + k0)
           if generator is None else generator)
    rows = int(uid.max()) + 1 if uid.size else 0
    u = torch.rand((rows, n), generator=gen).numpy()[uid]
    if not uniform:
        u1, u2 = 1.0 - u[:, 0::2].astype(np.float64), u[:, 1::2]
        u = (np.sqrt(-2.0 * np.log(u1))
             * np.cos(2.0 * np.pi * u2)).astype(np.float32)
    return u.reshape((len(uid),) + tuple(shape))


# straight ahead at 0.3 gas: the warm-up action of the JAX bench.py's
# driving metrics
WARMUP_ACTION = (0.0, 0.3, 0.0)


def make_ring_policy(policy: DiffusionPolicy, stats=None,
                     sampler: str = "ddim", num_inference_steps: int = 10,
                     ddim_spacing: str = "leading", amp: bool = False,
                     init_noise_fn: Optional[Callable] = None,
                     seed: int = 0, warmup: int = 0,
                     denoise_microbatches: int = 1,
                     interp_actions: bool = False) -> Callable:
    """policy_fn(params, carry, obs, car_position, car_velocity)
    -> ((B, 3) actions, carry).

    init_noise_fn(uid, k0) -> (B, horizon, prediction_dim) x_T for the
    denoise at frame k0; by default `keyed_init_noise(uid, k0, ..., seed,
    cfg.uniform_init)`, keyed per global env id (`uid`), so ddim and dpmpp
    give each env the same actions however the envs are split over ranks.
    The ddpm sampler also draws batch-shaped per-step noise, from a CPU
    generator seeded by seed * 1_000_003 + k0: that draw depends on the
    batch, so ddpm is not shard-invariant (nor is it in the JAX package).

    warmup > 0 drives WARMUP_ACTION for the first `warmup` frames, with
    no denoise, while the rings fill with real observations (the driving
    metrics of the JAX bench.py use warmup = obs_horizon * step_size).
    denoise_microbatches = M splits each denoise into M sampler calls over
    slices of the batch, with the slices of one x_T draw.

    interp_actions: between two denoises, frame j after the denoise takes
    the queue's rows 0 and 1 interpolated linearly at j / step_size
    (`eval.rollout.interpolate_actions`, the JAX bench's --interp-actions)
    in place of row 0 held for step_size frames."""
    cfg = policy.config
    dev = policy.device
    L = cfg.obs_horizon * cfg.step_size
    norm_batch, unnorm_actions = make_obs_normalizers(stats, dev)
    sub_idx = torch.arange(cfg.step_size - 1, L, cfg.step_size, device=dev)
    warm_action = torch.tensor(WARMUP_ACTION, dtype=torch.float32).to(dev)
    cast_cache: dict = {}
    uid_cache: dict = {}

    def keyed(uid, k0, gen):
        # the carry keeps one uid tensor: read it back once, not a denoise
        if uid_cache.get("src") is not uid:
            uid_cache["src"], uid_cache["np"] = uid, uid.cpu().numpy()
        x = keyed_init_noise(uid_cache["np"], k0,
                             (cfg.horizon, cfg.prediction_dim), seed,
                             cfg.uniform_init, generator=gen)
        return torch.from_numpy(x).to(dev)

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
            x_T = (keyed(uid, k0, gen) if init_noise_fn is None
                   else init_noise_fn(uid, k0))
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
        elif interp_actions:
            from ..eval.rollout import interpolate_actions

            j = (k0 - warmup) % cfg.step_size
            actions = interpolate_actions(queue[:, :2], cfg.step_size)[:, j]
        else:
            actions = queue[:, 0]
        hist["action"] = roll(hist["action"], actions)
        return actions, {"hist": hist, "queue": queue, "k": k0 + 1,
                         "uid": uid}

    return policy_fn


def env_policy_fn(policy_fn: Callable) -> Callable:
    """Adapt a ring policy to `envs.vector.rollout_policy_sharded`: the
    returned policy(params, carry, states, prev_res), the JAX ring policy's
    signature, feeds policy_fn the previous step's frame, car position and
    hull velocity, as the JAX ring policy reads them from its `prev_res`."""

    def policy(params, carry, states, prev_res):
        del states
        return policy_fn(params, carry, prev_res.obs,
                         prev_res.info.car_position,
                         prev_res.info.car_velocity)

    return policy


def env_policy(policy_fn: Callable, params) -> Callable:
    """Adapt a ring policy to `envs.vector.rollout_policy`: policy(carry,
    states, prev_res), `env_policy_fn`'s policy with the params bound."""
    return functools.partial(env_policy_fn(policy_fn), params)
