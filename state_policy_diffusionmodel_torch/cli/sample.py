"""Offline sampling with denoising animations, PyTorch (the reference's
generate.py).

    python -m state_policy_diffusionmodel_torch.cli.sample \
        --run_dir artifacts/r5blend_best --ema --dataset_dir D \
        --dataset_name S.zarr --model_name DDIM --num_inference_steps 10

Counterpart of the JAX package's `cli/sample.py`, with its flags, plus
`--device` (default cuda; cpu runs the plain PyTorch path). The run loads
through `train.checkpoints.load_run` (`--ema` for the EMA weights); the
first validation window of the port's `DataModule` over the dataset (any
zarr store the port reads) is sampled with `--model_name DDPM | DDIM |
DPMPP` keeping the whole denoising history, and the positions and actions
of that history are written as two animations (`<out_dir>/<model>_
positions.mp4` and `_actions.mp4`, or .gif without ffmpeg), which need
matplotlib and Pillow. x_T, and DDPM's per-step noise, come from a CPU
generator seeded with `--seed`. `sample_history` is the computation alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

SAMPLERS = {"DDPM": "ddpm", "DDIM": "ddim", "DPMPP": "dpmpp"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True,
                   help="training run dir (hparams.yaml + STATS.pkl + "
                        "checkpoints)")
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--model_name", default="DDPM", choices=list(SAMPLERS),
                   help="DPMPP = DPM-Solver++(2M): lower error than DDIM at "
                        "equal steps, same cost")
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--ddim_spacing", default="leading",
                   choices=["leading", "trailing"])
    p.add_argument("--ema", action="store_true",
                   help="load the EMA weights instead of the raw params")
    p.add_argument("--gaussian_init", action="store_true",
                   help="N(0,1) sampler init instead of the reference quirk")
    p.add_argument("--ddim_compat_100", action="store_true",
                   help="replicate generate.py's 100-step DDIM scheduler "
                        "swap")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def load_window(policy, stats, dataset_dir: str, dataset_name: str,
                split_seed=None):
    """The first validation window of the dataset as a batch of one on the
    policy's device, normalized with the run's stats. The 80/20 split is
    seeded by `split_seed` (None: a fresh split, as the JAX CLI's)."""
    import torch

    from ..data.dataset import DataModule

    cfg = policy.config
    dm = DataModule(batch_size=1, data_dir=dataset_dir, T_obs=cfg.obs_horizon,
                    T_pred=cfg.pred_horizon, seed=split_seed, stats=stats,
                    step_size=cfg.step_size)
    dm.setup(dataset_name)
    batch = dm.data_full.batch(dm.val_idx[:1], image_frames=cfg.obs_horizon)
    return {k: torch.from_numpy(v).to(policy.device)
            for k, v in batch.items()}


def sample_history(policy, params, batch, model_name: str = "DDPM",
                   num_inference_steps: int = 100,
                   ddim_spacing: str = "leading",
                   ddim_compat_100: bool = False, seed: int = 0,
                   init_noise=None):
    """(steps+1, B, horizon, 5) denoising history of `batch` with the named
    sampler. x_T is `init_noise` when given, else drawn, like DDPM's noise,
    from a CPU generator seeded with `seed`."""
    import torch

    return policy.sample(params, batch, torch.Generator().manual_seed(seed),
                         sampler=SAMPLERS[model_name],
                         num_inference_steps=num_inference_steps,
                         history=True, ddim_compat_100=ddim_compat_100,
                         ddim_spacing=ddim_spacing, init_noise=init_noise)


def main(argv=None):
    """Sample, write the two animations; returns (history as numpy, the
    two paths written)."""
    args = parse_args(argv)
    from .. import diffusion, resolve_device
    from ..train.checkpoints import load_run
    from ..utils import plotting

    device = resolve_device(args.device)
    policy, params, stats = load_run(args.run_dir, device, ema=args.ema)
    if args.gaussian_init:
        policy = diffusion.DiffusionPolicy(
            dataclasses.replace(policy.config, uniform_init=False), device)
    batch = load_window(policy, stats, args.dataset_dir, args.dataset_name)
    t0 = time.perf_counter()
    hist = sample_history(policy, params, batch, args.model_name,
                          args.num_inference_steps, args.ddim_spacing,
                          args.ddim_compat_100, args.seed)
    hist = hist.cpu().numpy()
    print(f"sampling took {time.perf_counter() - t0:.2f}s "
          f"({hist.shape[0] - 1} denoise steps)")

    out_dir = args.out_dir or os.path.join(args.run_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    paths = [plotting.denoising_animation(
        hist, os.path.join(out_dir, f"{args.model_name}_{kind}.mp4"),
        kind=kind) for kind in ("positions", "actions")]
    print("wrote", paths[0], "and", paths[1])
    return hist, paths


if __name__ == "__main__":
    main()
