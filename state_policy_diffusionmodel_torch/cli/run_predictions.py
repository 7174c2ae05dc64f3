"""Live closed-loop demo with prediction overlays, PyTorch (the reference's
run_predictions.py).

    python -m state_policy_diffusionmodel_torch.cli.run_predictions \
        --run_dir artifacts/r5blend_best --ema [--drive policy]

Counterpart of the JAX package's `cli/run_predictions.py`, with its flags,
plus `--device` (default cuda; cpu runs the plain PyTorch path). One env
drives on track `--track_seed` (built on the host where the track cache
does not hold it). With `--drive pid` the lane follower steers and the
policy, every `--predict_every` frames once the observation ring is full,
samples a trajectory from the ring subsampled every step_size frames; with
`--drive policy` the policy drives itself from then on (a denoise every
step_size frames, the action row `inpaint_horizon` held in between, the
ring recording the executed action) and every `--predict_every`-th
trajectory is overlaid. Up to 8 predicted trajectories are drawn into the
frames as red polylines (`render.Overlay`), and the augmented frames go to
a video at 25 fps (`--out`, .mp4 through ffmpeg, else .gif; Pillow
needed). x_T of each denoise comes from a CPU generator seeded with
(`--seed`, the frame index). `run_predictions` is the computation alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

MAX_LINES = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--predict_every", type=int, default=50)
    p.add_argument("--track_seed", type=int, default=42)
    p.add_argument("--mode", default="middle")
    p.add_argument("--target_velocity", type=float, default=30.0)
    p.add_argument("--sampler", default="ddim",
                   choices=["ddim", "ddpm", "dpmpp"])
    p.add_argument("--num_inference_steps", type=int, default=10)
    p.add_argument("--ddim_spacing", default="leading",
                   choices=["leading", "trailing"])
    p.add_argument("--ema", action="store_true",
                   help="load the EMA weights instead of the raw params")
    p.add_argument("--gaussian_init", action="store_true",
                   help="N(0,1) sampler init instead of the reference quirk")
    p.add_argument("--drive", default="pid", choices=["pid", "policy"],
                   help="pid = the reference demo (the PID drives, the "
                        "policy overlays predictions); policy = the policy "
                        "drives itself")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def track_bank(track_seed: int, device):
    """A one-track bank of `track_seed`, baked on `device`."""
    from .. import track

    return track.stack([track.build(track.make_track(track_seed),
                                    device=device)])


def run_predictions(policy, params, stats, bank, steps: int = 500,
                    predict_every: int = 50, mode: str = "middle",
                    target_velocity: float = 30.0, sampler: str = "ddim",
                    num_inference_steps: int = 10,
                    ddim_spacing: str = "leading", drive: str = "pid",
                    seed: int = 0,
                    sample_fn: Optional[Callable] = None) -> dict:
    """Drive one env on `bank` (one track) for up to `steps` frames.

    sample_fn(batch, step) -> (horizon, 5) normalized prediction replaces
    the policy's sampler when given (the tests use it to hand both
    packages the same predictions). Returns {"frames": (T, 96, 96, 3)
    uint8 augmented frames, "positions": (T, 2) car positions after each
    step, "actions": (T, 3) the actions executed, "predictions": [(frame,
    (horizon, 2) world points)] of the overlaid trajectories, "denoises":
    the number of sampler calls, "state": the env's last state, "overlay":
    the last overlay drawn or None}."""
    from .. import control
    from ..data import normalize as N
    from ..envs import car_racing as env
    from ..physics.car import sqrt
    from ..render import Overlay

    cfg = policy.config
    dev = policy.device
    ids = torch.zeros(1, dtype=torch.int32, device=dev)
    state, res = env.reset(bank, ids)
    ctrl_params = control.lane_follow_params(mode, target_velocity, dev)
    ctrl = control.lane_follow_init(1, dev)

    def default_sample(batch, step):
        x = policy.sample(params, batch, torch.Generator().manual_seed(
            seed * 1_000_003 + step), sampler=sampler,
            num_inference_steps=num_inference_steps,
            ddim_spacing=ddim_spacing)
        return x[0].cpu().numpy()

    sample_fn = sample_fn or default_sample
    # rolling raw observation rings (run_predictions.py:30-60): the last
    # obs_horizon * step_size frames, subsampled [::step_size]
    L = cfg.obs_horizon * cfg.step_size
    hist = {"image": [], "position": [], "velocity": [], "action": []}
    frames, positions, executed, overlay_pts, shown = [], [], [], [], []
    overlay, policy_action, denoises = None, None, 0
    every = cfg.step_size if drive == "policy" else predict_every
    for step in range(steps):
        vel = res.info.car_velocity
        speed = sqrt(vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1])
        action, ctrl = control.lane_follow(ctrl_params, ctrl, res.augmented,
                                           speed)
        hist["image"].append(res.obs[0].cpu().numpy().astype(np.float32)
                             / 255.0)
        hist["position"].append(res.info.car_position[0].cpu().numpy())
        hist["velocity"].append(vel[0].cpu().numpy())
        hist["action"].append(action[0].cpu().numpy())
        for k in hist:
            hist[k] = hist[k][-L:]

        if len(hist["position"]) >= L and step % every == 0:
            sub = {k: np.stack(v[::cfg.step_size])[None]
                   for k, v in hist.items()}
            npos, trans = N.normalize_position(sub["position"][0],
                                               stats["position"])
            batch = {
                "image": sub["image"],
                "position": np.asarray(npos, np.float32)[None],
                "velocity": N.normalize_data(sub["velocity"],
                                             stats["velocity"]),
                "action": N.normalize_data(sub["action"], stats["action"]),
            }
            batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                     for k, v in batch.items()}
            pred = sample_fn(batch, step)
            denoises += 1
            world = N.unnormalize_position(pred[:, :2], trans,
                                           stats["position"])
            # in policy mode the sampler runs every step_size frames for
            # control; only every predict_every-th trajectory is drawn
            if drive != "policy" or step % predict_every == 0:
                overlay_pts.append(np.asarray(world, np.float32))
                overlay_pts = overlay_pts[-MAX_LINES:]
                shown.append((step, overlay_pts[-1]))
            if drive == "policy":
                acts = N.unnormalize_data(pred[:, 2:5], stats["action"])
                policy_action = torch.from_numpy(np.asarray(
                    acts[cfg.inpaint_horizon], np.float32)).to(dev)[None]
        if overlay_pts:
            pts = np.zeros((MAX_LINES, cfg.horizon, 2), np.float32)
            valid = np.zeros(MAX_LINES, bool)
            for i, w in enumerate(overlay_pts):
                pts[i], valid[i] = w, True
            overlay = Overlay(torch.from_numpy(pts).to(dev),
                              torch.from_numpy(valid).to(dev))

        if drive == "policy" and policy_action is not None:
            action = policy_action            # held for step_size frames
            # the ring records the action executed on this frame
            hist["action"][-1] = action[0].cpu().numpy()
        state, res = env.step(state, bank, ids, action, overlay=overlay)
        frames.append(res.augmented[0].cpu().numpy())
        positions.append(res.info.car_position[0].cpu().numpy())
        executed.append(action[0].cpu().numpy())
        if bool(res.done[0]):
            break
    return {"frames": np.stack(frames), "positions": np.stack(positions),
            "actions": np.stack(executed), "predictions": shown,
            "denoises": denoises, "state": state, "overlay": overlay}


def main(argv=None) -> dict:
    """Run the demo and write its video; returns run_predictions' result
    with the video's path under "path"."""
    args = parse_args(argv)
    from .. import diffusion, resolve_device
    from ..train.checkpoints import load_run
    from ..utils import plotting

    device = resolve_device(args.device)
    policy, params, stats = load_run(args.run_dir, device, ema=args.ema)
    if args.gaussian_init:
        policy = diffusion.DiffusionPolicy(
            dataclasses.replace(policy.config, uniform_init=False), device)
    out = run_predictions(
        policy, params, stats, track_bank(args.track_seed, device),
        steps=args.steps, predict_every=args.predict_every, mode=args.mode,
        target_velocity=args.target_velocity, sampler=args.sampler,
        num_inference_steps=args.num_inference_steps,
        ddim_spacing=args.ddim_spacing, drive=args.drive, seed=args.seed)
    path = args.out or os.path.join(args.run_dir, "run_predictions.mp4")
    out["path"] = plotting.save_animation(list(out["frames"]), path, fps=25)
    print("wrote", out["path"], f"({len(out['frames'])} frames)")
    return out


if __name__ == "__main__":
    main()
