"""The denoiser U-Net, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/unet.py::UNetFiLM`:
inc 1->w; downs w->2w->4w->4w each followed by 4-head SelfAttention;
bottleneck 4w->8w->8w->4w; ups with skip concat (->2w, ->w, ->w) each
followed by attention; 1x1 out conv. FiLM conditioning on the flattened
observation vector in every down and up block; sinusoidal time embedding.
Input x is (B, T, D, 1), padded to multiples of 8 (three pooling levels).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    Conv, DoubleConv, DownBlock, SelfAttention, UpBlock, pad_to,
    sinusoidal_time_embedding, unpad,
)

# the reference's CLI name of the net and its reference width
MODEL, WIDTH = "UNet_Film", 64


class UNetFiLM(nn.Module):
    def __init__(self, cond_dim: int, out_channels: int = 1,
                 time_dim: int = 256, width: int = WIDTH,
                 in_channels: int = 1):
        super().__init__()
        self.time_dim = time_dim
        self.width = width
        w = width
        blocks = dict(time_dim=time_dim, cond_dim=cond_dim)
        self.DoubleConv_0 = DoubleConv(in_channels, w)
        self.DownBlock_0 = DownBlock(w, 2 * w, **blocks)
        self.DownBlock_1 = DownBlock(2 * w, 4 * w, **blocks)
        self.DownBlock_2 = DownBlock(4 * w, 4 * w, **blocks)
        self.DoubleConv_1 = DoubleConv(4 * w, 8 * w)
        self.DoubleConv_2 = DoubleConv(8 * w, 8 * w)
        self.DoubleConv_3 = DoubleConv(8 * w, 4 * w)
        self.UpBlock_0 = UpBlock(8 * w, 2 * w, **blocks)
        self.UpBlock_1 = UpBlock(4 * w, w, **blocks)
        self.UpBlock_2 = UpBlock(2 * w, w, **blocks)
        for i, c in enumerate((2 * w, 4 * w, 4 * w, 2 * w, w, w)):
            setattr(self, f"SelfAttention_{i}", SelfAttention(c))
        self.Conv_0 = Conv(w, out_channels, 1)

    def _sa(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"SelfAttention_{i}")(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """x: (B, T, D, 1); t: (B,) or (); cond: (B, ...) flattened for FiLM."""
        B = x.shape[0]
        t = torch.atleast_1d(torch.as_tensor(t, device=x.device))
        if t.shape[0] != B:
            t = t.expand(B)
        t_emb = sinusoidal_time_embedding(t, self.time_dim)

        x, pads = pad_to(x, 2 ** 3)
        x1 = self.DoubleConv_0(x)
        x2 = self._sa(0, self.DownBlock_0(x1, t_emb, cond))
        x3 = self._sa(1, self.DownBlock_1(x2, t_emb, cond))
        x4 = self._sa(2, self.DownBlock_2(x3, t_emb, cond))

        x5 = self.DoubleConv_3(self.DoubleConv_2(self.DoubleConv_1(x4)))

        h = self._sa(3, self.UpBlock_0(x5, x3, t_emb, cond))
        h = self._sa(4, self.UpBlock_1(h, x2, t_emb, cond))
        h = self._sa(5, self.UpBlock_2(h, x1, t_emb, cond))
        return unpad(self.Conv_0(h), pads)


def build_model(name: str, cond_dim: int, out_channels: int = 1,
                time_dim: int = 256, width: Optional[int] = None):
    """The U-Net by the reference's CLI name; width None is the reference
    plan's 64. Only the net the configurations run is here."""
    if name != MODEL:
        raise ValueError(f"the reference holds {MODEL!r}, not {name!r}")
    return UNetFiLM(cond_dim, out_channels=out_channels, time_dim=time_dim,
                    width=WIDTH if width is None else width)
