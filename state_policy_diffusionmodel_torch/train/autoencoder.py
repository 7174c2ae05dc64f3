"""Autoencoder pretraining, PyTorch: MSE reconstruction of dataset frames,
the global-norm clip at 1.0 and Adam at a ReduceLROnPlateau lr, a 90/10
split.

Counterpart of `state_policy_diffusionmodel_tpu/train/autoencoder.py`, with
its split, epoch order, optimizer and checkpoints: the frames live on the
device (uint8 when they are exact 8-bit values, /255 per batch), the split
and every epoch's order come from one `np.random.default_rng(seed)` drawn in
the JAX trainer's order, and each epoch's {'encoder', 'decoder'} params
are saved in the JAX package's npz form. The JAX trainer runs an epoch as
one device program; here the steps run one at a time, and the losses are
read back once an epoch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..diffusion.policy import init_module_
from ..models import Autoencoder
from ..params_from_jax import load_into, params_to_jax
from . import checkpoints as ckpt_lib
from .loop import Optimizer, TrainConfig, _AsyncSaver
from .lr_schedule import ReduceLROnPlateau

GRAD_CLIP = 1.0


def frames_on_device(images: np.ndarray, device) -> torch.Tensor:
    """(N, 96, 96, 3) frames in [0, 1] on the device: uint8 where every
    value is an exact 8-bit level (within 1e-3 of one, as the JAX trainer
    tests it), float32 otherwise."""
    scaled = images * np.float32(255.0)
    rounded = np.round(scaled)
    if np.abs(scaled - rounded).max() < 1e-3:
        return torch.from_numpy(rounded.astype(np.uint8)).to(device)
    return torch.from_numpy(images.astype(np.float32)).to(device)


def get_batch(data: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    batch = data[torch.from_numpy(idx).to(data.device)]
    if batch.dtype == torch.uint8:
        batch = batch.float() / 255.0
    return batch


def recon_loss(ae: torch.nn.Module, batch: torch.Tensor) -> torch.Tensor:
    return torch.mean((ae(batch) - batch) ** 2)


def autoencoder_params(ae: Autoencoder) -> Dict[str, torch.nn.Module]:
    """The {'encoder', 'decoder'} modules, the keys of the run's npz."""
    return {"encoder": ae.encoder, "decoder": ae.decoder}


def train_autoencoder(
    images: np.ndarray,
    out_dir: str,
    epochs: int = 50,
    batch_size: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    log=print,
    device="cuda",
    init: Optional[dict] = None,
) -> Dict:
    """images: (N, 96, 96, 3) float in [0, 1]. Returns {params, history}:
    params the trained Autoencoder, history the per-epoch `train_loss`
    (mean of the epoch's steps), `val_loss` and `lr`, and `step_loss`,
    every step's loss. init: a flax tree {'encoder', 'decoder'} to start
    from (the JAX trainer's init drawn from jax.random.key(seed), which
    torch cannot draw); by default flax's initializers drawn from a torch
    generator seeded by `seed`."""
    dev = resolve_device(device)
    ae = Autoencoder()
    if init is None:
        init_module_(ae, torch.Generator().manual_seed(seed))
    else:
        for name, mod in autoencoder_params(ae).items():
            load_into(mod, init[name])
    ae.to(dev)
    opt = Optimizer(autoencoder_params(ae),
                    TrainConfig(lr=lr, grad_clip=GRAD_CLIP))
    data = frames_on_device(images, dev)

    n = len(images)
    host_rng = np.random.default_rng(seed)
    split = int(n * 0.9)
    perm = host_rng.permutation(n)
    train_idx, val_idx = perm[:split], perm[split:]
    n_val_full = len(val_idx) // batch_size
    if n_val_full:
        val_chunks = val_idx[:n_val_full * batch_size].reshape(
            n_val_full, batch_size)
    else:
        # fewer val frames than one batch: one ragged batch (the
        # reference's tail evaluation); none at all gives nan
        val_chunks = [val_idx] if len(val_idx) else []

    plateau = ReduceLROnPlateau(lr=lr)
    cur_lr = lr
    history = {"train_loss": [], "val_loss": [], "lr": [], "step_loss": []}
    saver = _AsyncSaver()
    os.makedirs(out_dir, exist_ok=True)

    def save_epoch(leaves, epoch):
        ckpt_lib.save_checkpoint(out_dir, leaves, epoch)

    for epoch in range(epochs):
        order = host_rng.permutation(train_idx)
        k = len(order) // batch_size
        losses = []
        for idx in order[:k * batch_size].reshape(k, batch_size):
            opt.zero_grad()
            loss = recon_loss(ae, get_batch(data, idx))
            loss.backward()
            opt.step(cur_lr)
            losses.append(loss.detach())
        with torch.no_grad():
            vals = [recon_loss(ae, get_batch(data, idx)) for idx in val_chunks]
        step_losses = torch.stack(losses).cpu().numpy() if losses else \
            np.zeros(0, np.float32)
        val = float(torch.stack(vals).mean()) if vals else float("nan")
        cur_lr = plateau.update(val)
        history["step_loss"].extend(float(v) for v in step_losses)
        history["train_loss"].append(float(np.mean(step_losses)))
        history["val_loss"].append(val)
        history["lr"].append(cur_lr)
        log(f"epoch {epoch}: train {history['train_loss'][-1]:.5f} "
            f"val {val:.5f} lr {cur_lr:.2e}")
        saver.submit(save_epoch, params_to_jax(autoencoder_params(ae)), epoch)

    saver.wait()
    return {"params": ae.eval(), "history": history}
