"""Evaluation suite CLI, PyTorch (the maintained reference evaluation
scripts; see eval/suite.py).

    python -m state_policy_diffusionmodel_torch.cli.evaluate \
        consistency-positions --run_dir RUN --dataset_name S.zarr
    python -m state_policy_diffusionmodel_torch.cli.evaluate all ...

Counterpart of the JAX package's `cli/evaluate.py`, with its flags, plus
`--device` (default cuda; cpu runs the plain PyTorch path). The run loads
through `train.checkpoints.load_run` (hparams.yaml is parsed without
yaml); the dataset is a zarr store of the port's reader (uncompressed,
zlib or blosc). x_T of each
sampler call comes from a CPU generator seeded as the JAX CLI seeds its
keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time

EVALS = ["consistency-positions", "consistency-actions", "precision",
         "robustness", "accuracy", "compare", "smoke"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("eval", choices=EVALS + ["all"])
    p.add_argument("--run_dir", required=True)
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--window", type=int, default=70)
    p.add_argument("--n_runs", type=int, default=5)
    p.add_argument("--track_seed", type=int, default=42)
    p.add_argument("--sampler", default="ddim",
                   choices=["ddim", "ddpm", "dpmpp"],
                   help="dpmpp = DPM-Solver++(2M), second-order multistep: "
                        "lower error than DDIM at equal steps, same cost")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--ema", action="store_true",
                   help="load the EMA weights (checkpoints_ema/, runs "
                        "trained with --ema_decay) instead of raw params")
    p.add_argument("--gaussian_init", action="store_true",
                   help="init reverse diffusion from N(0,1) instead of the "
                        "reference's uniform-[0,1) quirk")
    p.add_argument("--ddim_spacing", default="leading",
                   choices=["leading", "trailing"],
                   help="trailing removes the few-step DDIM bias "
                        "(leading = diffusers/reference default)")
    p.add_argument("--max_windows", type=int, default=None)
    p.add_argument("--epoch", type=int, default=None,
                   help="load this specific epoch's checkpoint instead of "
                        "the latest")
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the chosen evals; returns {eval name: its full result, with its
    wall seconds under "seconds"}, and prints (and with --out writes) each
    one's summary."""
    args = parse_args(argv)
    import dataclasses

    import numpy as np

    from .. import diffusion, eval as E, resolve_device
    from ..data.dataset import DataModule
    from ..train.checkpoints import load_run

    device = resolve_device(args.device)
    policy, params, stats = load_run(args.run_dir, device, ema=args.ema,
                                     epoch=args.epoch)
    if args.gaussian_init:
        policy = diffusion.DiffusionPolicy(
            dataclasses.replace(policy.config, uniform_init=False), device)
    cfg = policy.config

    dm = DataModule(batch_size=1, data_dir=args.dataset_dir,
                    T_obs=cfg.obs_horizon, T_pred=cfg.pred_horizon,
                    stats=stats, step_size=cfg.step_size)
    dm.setup(args.dataset_name)
    ctx = E.EvalContext(policy=policy, params=params, dataset=dm.data_full,
                        track_seed=args.track_seed, sampler=args.sampler,
                        num_inference_steps=args.num_inference_steps,
                        ddim_spacing=args.ddim_spacing)

    def run_one(name):
        w, n = args.window, args.n_runs
        if name == "consistency-positions":
            return E.position_consistency(ctx, w, n)
        if name == "consistency-actions":
            return E.action_consistency(ctx, w, n)
        if name == "precision":
            return E.precision(ctx, w, n)
        if name == "robustness":
            return E.robustness(ctx, w, n)
        if name == "accuracy":
            return E.position_accuracy(ctx, args.max_windows)
        if name == "compare":
            return E.compare_position_actions(ctx, w)
        if name == "smoke":
            fig = (os.path.splitext(args.out)[0] + "_smoke_overlay.png"
                   if args.out else None)
            return E.smoke(ctx, 0, fig_path=fig)
        raise ValueError(name)

    results, full = {}, {}
    for name in (EVALS if args.eval == "all" else [args.eval]):
        print(f"=== {name} ===")
        t0 = time.perf_counter()
        out = run_one(name)
        out["seconds"] = time.perf_counter() - t0
        full[name] = out
        summary = {k: (np.asarray(v).tolist() if isinstance(
            v, (np.ndarray, np.generic)) else v)
            for k, v in out.items()
            if not (hasattr(v, "size") and np.asarray(v).size > 200)}
        results[name] = summary
        print(json.dumps(summary, default=str)[:1200])

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, default=str, indent=1)
        print("wrote", args.out)
    return full


if __name__ == "__main__":
    main()
