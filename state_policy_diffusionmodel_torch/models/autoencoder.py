"""Conv autoencoder vision encoder, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/autoencoder.py::Encoder`:
3->16->32->64 with three 2x2 stride-2 convs (the first padded by 1, so 96
becomes 49, then 24, then 12), flatten, Dense(latent). `Decoder` mirrors it with three 2x2
stride-2 transposed convs, and `Autoencoder` holds both as `encoder` and
`decoder`, the keys of an autoencoder run's params.npz.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ConvTranspose, Dense


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


class Decoder(nn.Module):
    """(B, latent) -> (B, 96, 96, channels) in (0, 1): Dense to 12x12x64
    (NHWC), then ConvTranspose 2x2 / stride 2 to 24, 48 and 96 with ReLU,
    ReLU and a sigmoid."""

    def __init__(self, latent_dim: int = 128, channels: int = 3):
        super().__init__()
        self.Dense_0 = Dense(latent_dim, 64 * 12 * 12)
        self.ConvTranspose_0 = ConvTranspose(64, 32, 2, stride=2)     # 24
        self.ConvTranspose_1 = ConvTranspose(32, 16, 2, stride=2)     # 48
        self.ConvTranspose_2 = ConvTranspose(16, channels, 2, stride=2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(z).reshape(-1, 12, 12, 64)
        x = F.relu(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return torch.sigmoid(self.ConvTranspose_2(x))


class Autoencoder(nn.Module):
    def __init__(self, latent_dim: int = 128, channels: int = 3):
        super().__init__()
        self.encoder = Encoder(latent_dim, channels)
        self.decoder = Decoder(latent_dim, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
