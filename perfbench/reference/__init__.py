"""The benchmark's plain reference: a frozen copy of the port's env,
renderer, nets, sampler and weight loading, in plain PyTorch.

The files under `physics/`, `track/`, `render/` (but `cuda_sampler.py`),
`envs/car_racing.py`, `models/` (but `cuda_ops.py`), `diffusion/` and
`params_from_jax.py` were copied from `state_policy_diffusionmodel_torch`
when the benchmark was written, cut to what the cells run (UNetFiLM, the
conv-AE and ResNet-18 encoders, DDIM in float32), and are not kept in
step with it: a later change to the port is judged against them.
`models/cuda_ops.py` and `render/cuda_sampler.py` hold only the plain
versions of the port's kernels. `checkpoints.py`, `data.py` and
`train.py` are written for the benchmark: the run loading, the training
windows and the training step (loss, gradient, clip, Adam, EMA) from
their definitions. Nothing here imports the port or JAX.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
