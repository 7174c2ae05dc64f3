"""Diffusion policy training CLI, PyTorch.

    python -m state_policy_diffusionmodel_torch.cli.train_policy \
        --dataset_dir DIR --dataset_name NAME [...]

Counterpart of the JAX package's `cli/train_policy.py`, with its flags and
defaults, plus `--device` (default cuda; cpu runs the plain PyTorch path).
The dataset is a zarr store of the port's reader (uncompressed or zlib; a
blosc store raises). `--encoder_ckpt` takes an autoencoder run directory
or one of its `checkpoints/epoch=K` directories and reads the encoder from
its params.npz. The validation sample figures (`train/sample_viz.py`) are
on unless `--no_sample_viz`; they need matplotlib, and where it is missing
(the GPU machine) the CLI raises and names the flag. Flags whose modules
are not ported raise NotImplementedError and name their ROADMAP.md item:
--tensorboard, --profile_dir, --vision_encoder resnet18 and --model UNet.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from datetime import datetime


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="Train the diffusion policy")
    p.add_argument("--n_epochs", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--min_lr", type=float, default=0.0,
                   help="plateau-decay floor (torch min_lr; reference "
                        "default 0). Recommended with --no_early_stop")
    p.add_argument("--lr_schedule", default="plateau",
                   choices=["plateau", "cosine"],
                   help="cosine = half-cosine lr->min_lr over --n_epochs, "
                        "ignoring val")
    p.add_argument("--obs_horizon", type=int, default=10)
    p.add_argument("--pred_horizon", type=int, default=30)
    p.add_argument("--inpaint_horizon", type=int, default=1)
    p.add_argument("--step_size", type=int, default=5)
    p.add_argument("--noise_steps", type=int, default=1000)
    p.add_argument("--model", default="UNet_Film",
                   choices=["UNet_Film", "UNet_FilmnoAttention", "UNet"])
    p.add_argument("--model_width", type=int, default=None,
                   help="U-Net base channel count; default = the "
                        "reference channel plan (64)")
    p.add_argument("--noise_scheduler", default="linear",
                   choices=["linear", "linear_v2", "cosine"])
    p.add_argument("--vision_encoder", default="autoencoder",
                   choices=["autoencoder", "resnet18", "none"])
    p.add_argument("--train_encoder", action="store_true",
                   help="backprop into the vision encoder (the reference "
                        "freezes the AE)")
    p.add_argument("--encoder_ckpt", default=None,
                   help="pretrained autoencoder run or checkpoint dir")
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--out_dir", default="./tb_logs")
    p.add_argument("--amp", action="store_true")
    p.add_argument("--device_data", action="store_true",
                   help="keep the dataset on the device and gather "
                        "training windows there")
    p.add_argument("--no_early_stop", action="store_true",
                   help="disable the reference's lr-monitor early stopping")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0: an EMA of the params, saved under "
                        "checkpoints_ema/")
    p.add_argument("--insurance_dir", default=None,
                   help="write an fp16 best-val params snapshot (+ "
                        "hparams/STATS) into this dir whenever val improves")
    p.add_argument("--tensorboard", action="store_true",
                   help="not ported")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--version", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in the run dir "
                        "(requires --version of an existing run)")
    p.add_argument("--profile_dir", default=None, help="not ported")
    p.add_argument("--no_sample_viz", action="store_true",
                   help="skip the validation-time sample figures "
                        "(needed where matplotlib is missing)")
    p.add_argument("--sample_viz_steps", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.tensorboard:
        raise NotImplementedError(
            "--tensorboard: TensorBoard logging is not ported (ROADMAP.md "
            "Queue 1, the training slice's deferred modules)")
    if args.profile_dir:
        raise NotImplementedError(
            "--profile_dir: use tools/profile_torch_policy.py --what "
            "train_step (ROADMAP.md Queue 1)")
    if not args.no_sample_viz and importlib.util.find_spec(
            "matplotlib") is None:
        raise RuntimeError(
            "the validation sample figures (on unless --no_sample_viz) "
            "need matplotlib, which is not installed here: pass "
            "--no_sample_viz")
    if args.vision_encoder == "resnet18":
        raise NotImplementedError(
            "--vision_encoder resnet18: ResNet18GN is not ported (ROADMAP.md "
            "Queue 1)")
    if args.model == "UNet":
        raise NotImplementedError(
            "--model UNet: UNetSimple is not ported (ROADMAP.md Queue 1)")


def load_encoder_tree(ckpt: str) -> dict:
    """(checkpoint dir, the encoder's flax tree) from an autoencoder run
    (its newest epoch) or from one checkpoints/epoch=K directory."""
    from ..params_from_jax import load_npz
    from ..train.checkpoints import latest_checkpoint

    latest = latest_checkpoint(ckpt)
    path = latest if latest is not None else ckpt
    tree = load_npz(os.path.join(path, "params.npz"))
    if "encoder" not in tree:
        raise ValueError(f"{path}/params.npz holds no ['encoder'] tree")
    return path, tree["encoder"]


def main(argv=None):
    args = parse_arguments(argv)
    _refuse_unported(args)
    import torch

    from .. import diffusion, resolve_device, train
    from ..data.dataset import DataModule
    from ..utils.printing import print_dataset_info, print_hyperparameters

    device = resolve_device(args.device)
    version = args.version or datetime.now().strftime("version_%Y%m%d_%H%M%S")
    out_dir = os.path.join(args.out_dir, version)

    cfg = diffusion.PolicyConfig(
        noise_steps=args.noise_steps,
        obs_horizon=args.obs_horizon,
        pred_horizon=args.pred_horizon,
        inpaint_horizon=args.inpaint_horizon,
        model=args.model,
        model_width=args.model_width,
        noise_scheduler_type=args.noise_scheduler,
        step_size=args.step_size,
        vision_encoder=args.vision_encoder,
        train_encoder=args.train_encoder,
    )
    tcfg = train.TrainConfig(
        epochs=args.n_epochs, batch_size=args.batch_size, lr=args.lr,
        min_lr=args.min_lr, lr_schedule=args.lr_schedule,
        amp=args.amp, seed=args.seed,
        device_data=args.device_data,
        early_stop=not args.no_early_stop, tensorboard=args.tensorboard,
        ema_decay=args.ema_decay, insurance_dir=args.insurance_dir)
    print_hyperparameters(cfg, tcfg)

    dm = DataModule(batch_size=args.batch_size, data_dir=args.dataset_dir,
                    T_obs=args.obs_horizon, T_pred=args.pred_horizon,
                    seed=args.seed, step_size=args.step_size)
    dm.setup(args.dataset_name)
    print_dataset_info(args.dataset_name, len(dm.data_full),
                       len(dm.train_idx), len(dm.val_idx),
                       args.obs_horizon, args.pred_horizon, args.step_size)

    policy = diffusion.DiffusionPolicy(cfg, device)
    params = None
    if args.encoder_ckpt:
        path, enc = load_encoder_tree(args.encoder_ckpt)
        params = policy.init_params(torch.Generator().manual_seed(0),
                                    encoder_params=enc)
        print(f"loaded pretrained encoder from {path}")

    trainer = train.Trainer(policy, tcfg, out_dir)
    sample_hook = None
    if not args.no_sample_viz:
        # the reference's quarter-epoch visual feedback: full reverse
        # diffusion on a fixed validation window, position and action
        # overlay figures (diffusion_ddpm.py:100-113,351-422)
        sample_hook = train.make_sample_hook(
            policy, dm, out_dir, num_inference_steps=args.sample_viz_steps)
    result = trainer.fit(dm, params=params, resume=args.resume,
                         sample_hook=sample_hook)
    print(f"done; final lr {result['lr']}, artifacts in {out_dir}")
    return result


if __name__ == "__main__":
    main()
