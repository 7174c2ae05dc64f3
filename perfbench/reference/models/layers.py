"""Shared model building blocks of the denoiser, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/layers.py`. Tensors
stay NHWC as in the JAX package, and each submodule carries the name the
flax module gives it (`DoubleConv_0`, `MultiHeadDotProductAttention_0`,
...), so that a checkpoint's key paths name the torch parameters directly
(`params_from_jax.py`).

Quirks kept from the reference:
- `DoubleConv` applies *the same* GroupNorm scale/bias after both convs when
  mid == out (one shared norm module in the reference).
- GroupNorm and LayerNorm use eps 1e-6 and the fast variance
  E[x^2] - E[x]^2 clamped at 0, as flax does; torch's defaults differ.
- Norm statistics are f32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_ops


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t: (B,) -> (B, dim) f32, inv_freq = 10000^(-2i/dim)."""
    t = t.float()[:, None]
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=t.device) / dim))
    ang = t * inv_freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def pad_to(x: torch.Tensor, stride: int):
    """Zero-pad H, W (axes 1, 2 of NHWC) to multiples of `stride` with the
    reference's asymmetric split (the smaller half first)."""
    h, w = x.shape[1], x.shape[2]
    nh = h + (stride - h % stride) % stride
    nw = w + (stride - w % stride) % stride
    lh, uh = (nh - h) // 2, (nh - h) - (nh - h) // 2
    lw, uw = (nw - w) // 2, (nw - w) - (nw - w) // 2
    x = F.pad(x, (0, 0, lw, uw, lh, uh))
    return x, (lw, uw, lh, uh)


def unpad(x: torch.Tensor, pads):
    lw, uw, lh, uh = pads
    if lh + uh > 0:
        x = x[:, lh:x.shape[1] - uh, :, :]
    if lw + uw > 0:
        x = x[:, :, lw:x.shape[2] - uw, :]
    return x


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsampling with align_corners=True on NHWC; an axis of
    length 1 is tiled."""

    def interp(arr, axis, out_len):
        in_len = arr.shape[axis]
        if in_len == 1:
            reps = [1] * arr.ndim
            reps[axis] = out_len
            return arr.repeat(*reps)
        pos = torch.linspace(0.0, in_len - 1.0, out_len, device=arr.device)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=in_len - 1)
        w = (pos - lo).to(arr.dtype)
        a = torch.index_select(arr, axis, lo)
        b = torch.index_select(arr, axis, hi)
        shape = [1] * arr.ndim
        shape[axis] = out_len
        w = w.reshape(shape)
        return a * (1 - w) + b * w

    x = interp(x, 1, x.shape[1] * factor)
    return interp(x, 2, x.shape[2] * factor)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool on NHWC as a max of four strided slices."""
    a = torch.maximum(x[:, ::2, ::2], x[:, 1::2, ::2])
    b = torch.maximum(x[:, ::2, 1::2], x[:, 1::2, 1::2])
    return torch.maximum(a, b)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as numpy's `.astype(dtype)` of a constant."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as flax `nn.gelu(approximate=False)` writes it."""
    return 0.5 * x * torch.erfc(-x * _const(math.sqrt(0.5), x.dtype))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), softplus as logaddexp(x, 0) (jax.nn.mish)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


class Dense(nn.Linear):
    """flax `nn.Dense`: the input is cast to the parameters' dtype."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """flax `nn.Conv` on NHWC tensors (the weight stays OIHW)."""

    def forward(self, x):
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        return super().forward(x).permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: eps 1e-6, fast variance, f32 statistics, output
    in the input's dtype."""

    def __init__(self, features: int, eps: float = cuda_ops.GN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` on NHWC: statistics per (batch, group) over H, W
    and the group's channels, in at least f32, with the fast variance
    clamped at 0 and eps 1e-6; the output in the promoted dtype of the
    input and the parameters, as flax gives it."""

    def __init__(self, num_groups: int, features: int,
                 eps: float = cuda_ops.GN_EPS):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{features} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        G = self.num_groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(B, -1, G, C // G)
        mean = xg.mean((1, 3))
        var = ((xg * xg).mean((1, 3)) - mean * mean).clamp_min(0.0)
        shape = (B,) + (1,) * (x.ndim - 2) + (C,)
        mean = mean.repeat_interleave(C // G, -1).reshape(shape)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(C // G, -1)
        mul = mul.reshape(shape) * self.scale.to(xf.dtype)
        y = (xf - mean) * mul + self.bias.to(xf.dtype)
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class DoubleConv(nn.Module):
    """conv3x3 -> GroupNorm(1) -> GELU -> conv3x3 -> GroupNorm(1), with the
    shared-norm quirk and an optional per-(batch, channel) affine epilogue
    `post_scale * y + post_bias`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.out_channels = out_channels
        self.conv1_kernel = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self.conv2_kernel = nn.Parameter(
            torch.empty(out_channels, out_channels, 3, 3))
        nn.init.kaiming_normal_(self.conv1_kernel)
        nn.init.kaiming_normal_(self.conv2_kernel)
        self.norm_scale = nn.Parameter(torch.ones(out_channels))
        self.norm_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, post_scale=None, post_bias=None):
        g, b = self.norm_scale, self.norm_bias
        B = x.shape[0]
        if post_scale is None:
            post_scale = x.new_ones((B, self.out_channels))
        if post_bias is None:
            post_bias = x.new_zeros((B, self.out_channels))
        return cuda_ops.double_conv(x, self.conv1_kernel, self.conv2_kernel,
                                    g, b, g, b, post_scale, post_bias)


class _MHA(nn.Module):
    """Multi-head attention with q/k/v packed as (B, T, heads*Dh) end to
    end; the softmax(q k^T) v core is `cuda_ops.attention_core`."""

    def __init__(self, channels: int, num_heads: int, qkv_features: int,
                 out_features: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(channels, qkv_features)
        self.key = Dense(channels, qkv_features)
        self.value = Dense(channels, qkv_features)
        self.out = Dense(qkv_features, out_features)

    def forward(self, x):
        out = cuda_ops.attention_core(self.query(x), self.key(x),
                                      self.value(x), self.num_heads)
        return self.out(out)


class SelfAttention(nn.Module):
    """Pre-LN 4-head attention + residual, then LN -> Dense -> GELU -> Dense
    + residual, over the H*W tokens of an NHWC map."""

    def __init__(self, channels: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(channels)
        self.MultiHeadDotProductAttention_0 = _MHA(channels, 4, channels,
                                                   channels)
        self.LayerNorm_1 = LayerNorm(channels)
        self.Dense_0 = Dense(channels, channels)
        self.Dense_1 = Dense(channels, channels)

    def forward(self, x):
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        attn = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(tokens))
        tokens = attn + tokens
        ff = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(tokens))))
        tokens = ff + tokens
        return tokens.reshape(B, H, W, C)


class _PostAffine(nn.Module):
    """The folded per-(batch, channel) conditioning of a block: time bias
    then FiLM, s*(y + tb) + b = s*y + (s*tb + b), as (post_scale, post_bias)
    for DoubleConv's epilogue."""

    def __init__(self, channels: int, time_dim: int, cond_dim: int):
        super().__init__()
        self.channels = channels
        self.time_dense = Dense(time_dim, channels)
        self.film_dense = Dense(cond_dim, 2 * channels)

    def forward(self, t_emb, cond):
        tb = self.time_dense(F.silu(t_emb))
        cond = cond.reshape(cond.shape[0], -1)
        emb = self.film_dense(mish(cond))
        emb = emb.reshape(-1, 2, self.channels)
        scale, bias = emb[:, 0], emb[:, 1]
        return scale, scale * tb + bias


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 cond_dim: int):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_channels, in_channels)
        self._PostAffine_0 = _PostAffine(out_channels, time_dim, cond_dim)
        self.DoubleConv_1 = DoubleConv(in_channels, out_channels)

    def forward(self, x, t_emb, cond):
        x = self.DoubleConv_0(max_pool_2x2(x))
        ps, pb = self._PostAffine_0(t_emb, cond)
        return self.DoubleConv_1(x, ps, pb)


class UpBlock(nn.Module):
    """in_channels counts the upsampled input and the skip together."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 cond_dim: int):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_channels, in_channels)
        self._PostAffine_0 = _PostAffine(out_channels, time_dim, cond_dim)
        self.DoubleConv_1 = DoubleConv(in_channels, out_channels)

    def forward(self, x, skip, t_emb, cond):
        x = torch.cat([upsample_align_corners(x, 2), skip], dim=-1)
        x = self.DoubleConv_0(x)
        ps, pb = self._PostAffine_0(t_emb, cond)
        return self.DoubleConv_1(x, ps, pb)
