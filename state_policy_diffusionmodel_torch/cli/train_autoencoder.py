"""Autoencoder pretraining and reconstruction-eval CLI, PyTorch.

    python -m state_policy_diffusionmodel_torch.cli.train_autoencoder \
        --dataset data/run.zarr [--epochs 50] [--device cpu]
    python -m state_policy_diffusionmodel_torch.cli.train_autoencoder \
        --dataset data/run.zarr --eval_run tb_logs_autoencoder/<version>

Counterpart of the JAX package's `cli/train_autoencoder.py`, with its flags
and defaults, plus `--device` (default cuda; cpu runs the plain PyTorch
path). The dataset is a zarr store of the port's reader (uncompressed,
zlib or blosc). A run directory
holds `checkpoints/epoch=K/params.npz` with the ['encoder'] and
['decoder'] trees: the training CLIs' `--encoder_ckpt` of both packages
take it. `--eval_run` prints the reconstruction MSE of `--n_eval` frames
and writes them with their reconstructions to `<run>/reconstructions.png`
(that needs matplotlib).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, help="zarr dataset path")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out_dir", default="./tb_logs_autoencoder")
    p.add_argument("--version", default=None)
    p.add_argument("--eval_run", default=None,
                   help="instead of training, write a reconstruction grid "
                        "for this trained run dir (eval_autoencoder.py "
                        "parity)")
    p.add_argument("--n_eval", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def load_autoencoder(run_dir: str, device):
    """The Autoencoder of a run's newest checkpoint (or of one
    checkpoints/epoch=K directory)."""
    from ..models import Autoencoder
    from ..params_from_jax import load_into, load_npz
    from ..train.checkpoints import latest_checkpoint

    path = latest_checkpoint(run_dir) or run_dir
    tree = load_npz(os.path.join(path, "params.npz"))
    ae = Autoencoder()
    load_into(ae, tree)
    return ae.to(device).eval()


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from .. import resolve_device
    from ..data.replay_buffer import load_zarr
    from ..train.autoencoder import train_autoencoder

    device = resolve_device(args.device)
    buf = load_zarr(args.dataset)
    images = np.asarray(buf.data["img"], np.float32)
    if images.max() > 1.5:
        images = images / 255.0

    if args.eval_run:
        from ..utils import plotting

        ae = load_autoencoder(args.eval_run, device)
        idx = np.linspace(0, len(images) - 1, args.n_eval).astype(int)
        with torch.no_grad():
            recon = ae(torch.from_numpy(images[idx]).to(device)).cpu().numpy()
        mse = float(np.mean((recon - images[idx]) ** 2))
        out = os.path.join(args.eval_run, "reconstructions.png")
        plotting.image_grid(
            np.concatenate([images[idx], recon]), out, ncols=args.n_eval)
        print(f"reconstruction MSE {mse:.6f}; grid written to {out}")
        return {"mse": mse, "grid": out}

    version = args.version or datetime.now().strftime("version_%Y%m%d_%H%M%S")
    out = os.path.join(args.out_dir, version)
    result = train_autoencoder(images, out, epochs=args.epochs,
                               batch_size=args.batch_size, lr=args.lr,
                               device=device)
    print("checkpoints in", out)
    return dict(result, out_dir=out)


if __name__ == "__main__":
    main()
