"""Conv autoencoder vision encoder, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/autoencoder.py::Encoder`:
3->16->32->64 with three 2x2 stride-2 convs (the first padded by 1, so 96
becomes 49, then 24, then 12), flatten, Dense(latent).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Dense


class Encoder(nn.Module):
    def __init__(self, latent_dim: int = 128, channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(channels, 16, 2, stride=2, padding=1)      # 49
        self.Conv_1 = Conv(16, 32, 2, stride=2)                       # 24
        self.Conv_2 = Conv(32, 64, 2, stride=2)                       # 12
        self.Dense_0 = Dense(64 * 12 * 12, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 96, 96, 3) in [0, 1] -> (B, latent_dim).

        The activations stay NHWC, so the flatten is in (h, w, c) order,
        the order the checkpoint's Dense_0 kernel was trained on."""
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        return self.Dense_0(x.reshape(x.shape[0], -1))

