"""The denoiser U-Nets, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/unet.py`. `UNetFiLM`:
inc 1->w; downs w->2w->4w->4w each followed by 4-head SelfAttention;
bottleneck 4w->8w->8w->4w; ups with skip concat (->2w, ->w, ->w) each
followed by attention; 1x1 out conv. FiLM conditioning on the flattened
observation vector in every down and up block; sinusoidal time embedding.
`UNetSimple`: the smaller plan (w, 2w, 8w, 16w), a residual DoubleConv
first in every down and up block, a time bias in the second one's
epilogue, and conditioning by a 32-wide embedding of the observation
concatenated as channels (`_CondConcat`). Input x is (B, T, D, 1), padded
to multiples of 8 (three pooling levels).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv, Dense, DoubleConv, DownBlock, SelfAttention, UpBlock, max_pool_2x2,
    pad_to, sinusoidal_time_embedding, unpad, upsample_align_corners,
)

COND_EMB = 32   # _CondConcat's embedding width


class UNetFiLM(nn.Module):
    def __init__(self, cond_dim: int, out_channels: int = 1,
                 time_dim: int = 256, with_attention: bool = True,
                 width: int = 64, in_channels: int = 1):
        super().__init__()
        self.time_dim = time_dim
        self.width = width
        self.with_attention = with_attention
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
        if with_attention:
            for i, c in enumerate((2 * w, 4 * w, 4 * w, 2 * w, w, w)):
                setattr(self, f"SelfAttention_{i}", SelfAttention(c))
        self.Conv_0 = Conv(w, out_channels, 1)

    def _sa(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if not self.with_attention:
            return h
        return getattr(self, f"SelfAttention_{i}")(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
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


class _CondConcat(nn.Module):
    """SiLU -> Dense(32) of the flattened observation, broadcast over H, W
    and concatenated as channels."""

    def __init__(self, cond_dim: int):
        super().__init__()
        self.Dense_0 = Dense(cond_dim, COND_EMB)

    def forward(self, x, cond):
        emb = self.Dense_0(F.silu(cond.reshape(cond.shape[0], -1)))
        emb = emb[:, None, None, :].expand(*x.shape[:3], emb.shape[-1])
        return torch.cat([x, emb], dim=-1)


class UNetSimple(nn.Module):
    """cond_dim None: no conditioning, so no `_CondConcat_*` and 32 fewer
    channels after each block, as the JAX net initialised without cond."""

    def __init__(self, cond_dim: Optional[int], out_channels: int = 1,
                 time_dim: int = 256, width: int = 16, in_channels: int = 1):
        super().__init__()
        self.time_dim = time_dim
        self.width = width
        self.use_cond = cond_dim is not None
        c = COND_EMB if self.use_cond else 0
        w = width
        self.DoubleConv_0 = DoubleConv(in_channels, w)
        # (in_ch, out_ch) of the three down and three up blocks
        plan = [(w, 2 * w), (2 * w + c, 8 * w), (8 * w + c, 16 * w),
                (16 * w + c + 8 * w + c, 8 * w), (8 * w + c + 2 * w + c, 4 * w),
                (4 * w + c + w, 2 * w)]
        for i, (cin, cout) in enumerate(plan):
            setattr(self, f"DoubleConv_{2 * i + 1}",
                    DoubleConv(cin, cin, residual=True))
            setattr(self, f"DoubleConv_{2 * i + 2}", DoubleConv(cin, cout))
            setattr(self, f"Dense_{i}", Dense(time_dim, cout))
            if self.use_cond:
                setattr(self, f"_CondConcat_{i}", _CondConcat(cond_dim))
        self.Conv_0 = Conv(2 * w + c, out_channels, 1)

    def _block(self, i: int, h, t_act, cond):
        h = getattr(self, f"DoubleConv_{2 * i + 1}")(h)
        h = getattr(self, f"DoubleConv_{2 * i + 2}")(
            h, post_bias=getattr(self, f"Dense_{i}")(t_act))
        if self.use_cond:
            h = getattr(self, f"_CondConcat_{i}")(h, cond)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, D, 1); t: (B,) or (); cond: (B, ...), required exactly
        when the net was built with a cond_dim."""
        if (cond is not None) != self.use_cond:
            raise ValueError("cond must be given exactly when the net was "
                             "built with a cond_dim")
        B = x.shape[0]
        t = torch.atleast_1d(torch.as_tensor(t, device=x.device))
        if t.shape[0] != B:
            t = t.expand(B)
        t_act = F.silu(sinusoidal_time_embedding(t, self.time_dim))

        x, pads = pad_to(x, 2 ** 3)
        x1 = self.DoubleConv_0(x)
        x2 = self._block(0, max_pool_2x2(x1), t_act, cond)
        x3 = self._block(1, max_pool_2x2(x2), t_act, cond)
        h = self._block(2, max_pool_2x2(x3), t_act, cond)
        for i, skip in ((3, x3), (4, x2), (5, x1)):
            h = torch.cat([upsample_align_corners(h, 2), skip], dim=-1)
            h = self._block(i, h, t_act, cond)
        return unpad(self.Conv_0(h), pads)


# name -> (class, its keyword arguments, its reference width)
MODEL_REGISTRY = {
    "UNet_Film": (UNetFiLM, dict(with_attention=True), 64),
    "UNet_FilmnoAttention": (UNetFiLM, dict(with_attention=False), 64),
    "UNet": (UNetSimple, {}, 16),
}


def model_entry(name: str):
    """(class, keyword arguments, reference width) of a model name; a name
    the registry does not hold takes UNetSimple's, as the JAX package's
    `build_model` does."""
    return MODEL_REGISTRY.get(name, MODEL_REGISTRY["UNet"])


def build_model(name: str, cond_dim: Optional[int], out_channels: int = 1,
                time_dim: int = 256, width: Optional[int] = None):
    """Model selection by the reference's CLI names. width: base channel
    count (None = the net's reference plan: 64 for the FiLM nets, 16 for
    UNetSimple). A name it does not know builds UNetSimple, as the JAX
    `build_model` does."""
    cls, kw, default_width = model_entry(name)
    return cls(cond_dim, out_channels=out_channels, time_dim=time_dim,
               width=default_width if width is None else width, **kw)
