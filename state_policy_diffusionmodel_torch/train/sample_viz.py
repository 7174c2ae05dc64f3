"""Validation-time sample figures: the reference's visual feedback loop.

Counterpart of `state_policy_diffusionmodel_tpu/train/sample_viz.py`. The
reference runs full reverse diffusion on validation batch 0 at every
validation check and logs position and action figures
(`models/diffusion_ddpm.py:100-113`, `:351-422`). `make_sample_hook`
builds that `sample_hook` for `Trainer.fit`: a fixed validation window is
sampled and the overlay figures are written as PNGs into
`<out_dir>/samples/`. x_T is `policy.init_noise` from a CPU generator
seeded with the step index (the JAX hook's threefry key cannot be
reproduced in torch). The figures need matplotlib, which the GPU machine
does not have: there, train with --no_sample_viz.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data import normalize as N
from ..diffusion import DiffusionPolicy


def make_sample_hook(policy: DiffusionPolicy, dm, out_dir: str,
                     tb_writer=None, sampler: str = "ddim",
                     num_inference_steps: Optional[int] = 50,
                     window_rank: int = 0):
    """sample_hook(params, step_idx) for `Trainer.fit`, on the
    `window_rank`-th validation window (fixed across the run, like the
    reference's `batch_idx == 0` gate). None when the validation split is
    empty. Raises ModuleNotFoundError at once where matplotlib is
    missing."""
    from ..utils import plotting

    plotting._plt()
    if len(dm.val_idx) == 0:
        return None
    ds = dm.data_full
    idx = int(np.asarray(dm.val_idx)[window_rank % len(dm.val_idx)])
    start, end = (int(v) for v in ds.indices[idx][:2])
    raw = {k: np.asarray(v[start:end:ds.step_size])
           for k, v in ds.train_data.items()}
    npos, translation = N.normalize_position(raw["position"],
                                             ds.stats["position"])
    dev = policy.device
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None].to(dev)
    batch = {"image": to(raw["image"]), "position": to(npos),
             "velocity": to(raw["velocity"]), "action": to(raw["action"])}

    cfg = policy.config
    obs_h, inp_h = cfg.obs_horizon, cfg.inpaint_horizon
    sample_dir = os.path.join(out_dir, "samples")
    os.makedirs(sample_dir, exist_ok=True)

    def hook(params, step_idx: int):
        x_T = policy.init_noise(1, torch.Generator().manual_seed(step_idx))
        pred = policy.sample(params, batch, sampler=sampler,
                             num_inference_steps=num_inference_steps,
                             init_noise=x_T)[0].cpu().numpy()
        pos = N.unnormalize_position(pred[:, :2], translation,
                                     ds.stats["position"])
        act = N.unnormalize_data(pred[:, 2:], ds.stats["action"])

        fig_pos = plotting.plot_prediction_overlay(
            positions_gt=raw["position"][obs_h:],
            positions_obs=raw["position"][:obs_h],
            positions_pred=pos[inp_h:],
            positions_inpaint=pos[:inp_h],
            title=f"val sample @ step {step_idx}")
        fig_act = plotting.plot_action_comparison(
            actions_pred=act,
            actions_gt=raw["action"][obs_h - inp_h:],
            inpaint_horizon=inp_h,
            title=f"val sample @ step {step_idx}")

        plt = plotting._plt()
        for tag, fig in (("positions", fig_pos), ("actions", fig_act)):
            arr = plotting.fig_to_array(fig)
            plotting.save_png(arr, os.path.join(
                sample_dir, f"step_{step_idx:07d}_{tag}.png"))
            if tb_writer is not None:
                tb_writer.add_image(f"val_sample/{tag}",
                                    arr.transpose(2, 0, 1), step_idx)
            plt.close(fig)

    return hook
