"""The nets' operators in plain PyTorch: 3x3 conv, GroupNorm(1) with its
activations, the U-Net's conv block and the attention core. The port runs
kernels of its own for some of them; these are their definitions."""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

GN_EPS = 1e-6  # flax GroupNorm / LayerNorm default


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 same-padding conv, NHWC in and out; w is OIHW."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gn_f32(h32, gamma, beta):
    """GroupNorm(1) on (B, HW, C) f32, eps 1e-6, variance E[x^2] - m^2
    clamped at 0."""
    m = h32.mean(dim=(1, 2), keepdim=True)
    v = ((h32 * h32).mean(dim=(1, 2), keepdim=True) - m * m).clamp_min(0.0)
    return ((h32 - m) * torch.rsqrt(v + GN_EPS) * gamma.float()
            + beta.float())


def gn_act(x, gamma, beta, ps: Optional[torch.Tensor] = None,
           pb: Optional[torch.Tensor] = None, gelu: bool = False):
    """GroupNorm(1) of NHWC x in f32, then GELU, then ps*y + pb, each
    optional; written in x's dtype."""
    B, H, W, C = x.shape
    y = gn_f32(x.float().reshape(B, H * W, C), gamma, beta)
    if gelu:
        y = gelu_exact(y)
    if ps is not None:
        y = y * ps.float()[:, None, :] + pb.float()[:, None, :]
    return y.to(x.dtype).reshape(B, H, W, C)


def double_conv(x, w1, w2, g1, b1, g2, b2, ps, pb):
    """conv -> GN -> GELU -> conv -> GN -> ps*y+pb."""
    h = gn_act(conv3x3(x, w1), g1, b1, gelu=True)
    return gn_act(conv3x3(h, w2), g2, b2, ps, pb)


@functools.lru_cache(maxsize=None)
def _sqrt_dh(Dh: int, dtype: torch.dtype) -> float:
    return float(torch.sqrt(torch.tensor(float(Dh))).to(dtype))


def attention_core(q, k, v, num_heads: int = 1):
    """Per-head softmax(q k^T / sqrt(Dh)) v over packed (B, T, heads*Dh):
    f32 scores and softmax, probabilities in v's dtype, f32 sums."""
    B, T, C = q.shape
    Dh = C // num_heads
    qh = q.reshape(B, T, num_heads, Dh) / _sqrt_dh(Dh, q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                     k.reshape(B, T, num_heads, Dh).float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       v.reshape(B, T, num_heads, Dh).float())
    return out.to(q.dtype).reshape(B, T, C)
