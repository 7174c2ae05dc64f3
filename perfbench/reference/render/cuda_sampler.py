"""The texel fetch of the renderer, plain PyTorch only (the port's K2 has
the same semantics: nearest texel, 0 off the field)."""

from __future__ import annotations

import torch

from ..track.generator import PLAYFIELD

ROWS, LANES = 72, 128


def texel_scale(tex_size: int) -> float:
    return tex_size / (2.0 * PLAYFIELD)


def texel_coords(cos_a, sin_a, pos, rx, ry, tex_size: int):
    c = cos_a[:, None, None]
    s = sin_a[:, None, None]
    px = (c * rx + s * ry) + pos[:, 0, None, None]
    py = ((-s) * rx + c * ry) + pos[:, 1, None, None]
    scale = texel_scale(tex_size)
    return (px + PLAYFIELD) * scale, (py + PLAYFIELD) * scale


def sample_banked(tex_bank: torch.Tensor, track_ids: torch.Tensor,
                  cos_a: torch.Tensor, sin_a: torch.Tensor,
                  pos: torch.Tensor, rx: torch.Tensor,
                  ry: torch.Tensor) -> torch.Tensor:
    """(B, 72, 128) int32 packed palette bytes."""
    T = tex_bank.shape[-1]
    fx, fy = texel_coords(cos_a, sin_a, pos, rx, ry, T)
    infield = (fx >= 0) & (fx < T) & (fy >= 0) & (fy < T)
    fi = torch.floor(fx).to(torch.int64).clamp(0, T - 1)
    fj = torch.floor(fy).to(torch.int64).clamp(0, T - 1)
    vals = tex_bank[track_ids.to(torch.int64)[:, None, None], fi, fj]
    return torch.where(infield, vals.to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=tex_bank.device))
