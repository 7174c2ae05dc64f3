"""Track geometry on the device: a bank of padded tracks and batched queries.

Counterpart of `state_policy_diffusionmodel_tpu/track/geometry.py`. The JAX
module holds one track and vmaps its queries; here the tracks live in a
bank with a leading U axis and every query takes `track_ids` (B,), the
track of each env. A per-env geometry is the bank with
`track_ids = arange(B)`.

The arrays are float32 as JAX makes them with x64 off: `build` casts the
generator's arrays, and PLAYFIELD and the texel scale enter the arithmetic
as float32 values.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..physics.car import sqrt
from . import texture
from .generator import PLAYFIELD, TRACK_WIDTH, Track, make_track

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".cache_tracks")


class TrackGeometry(NamedTuple):
    """Tensors of one track, or of a bank of U tracks with a leading axis."""

    seg_a: torch.Tensor   # (P, 2) tile start points (= xy[(i-1) % n])
    seg_b: torch.Tensor   # (P, 2) tile end points (= xy[i])
    beta: torch.Tensor    # (P,) centerline heading
    valid: torch.Tensor   # (P,) bool, i < n
    n: torch.Tensor       # () int32 number of tiles
    start: torch.Tensor   # (3,) car start (angle, x, y)
    tex: torch.Tensor     # (T, T) uint8 packed palette: base * 8 + lane


def build(track: Track, tex_size: int = texture.DEFAULT_TEX,
          bake: bool = True, device="cuda") -> TrackGeometry:
    """Geometry of one host-generated track on `device`."""
    dev = resolve_device(device)
    n = track.n
    xy = track.xy.copy()
    prev = np.zeros_like(xy)
    prev[:n] = np.roll(xy[:n], 1, axis=0)
    prev[n:] = xy[max(n - 1, 0)]
    xy[n:] = xy[max(n - 1, 0)]
    if bake:
        t2 = texture.bake_texture(track, tex_size)
        tex = (t2[..., 0] * np.uint8(8) + t2[..., 1]).astype(np.uint8)
    else:
        tex = np.zeros((tex_size, tex_size), np.uint8)
    return from_arrays(dict(seg_a=prev, seg_b=xy, beta=track.beta,
                            valid=track.valid, n=np.int32(n),
                            start=track.start, tex=tex), dev)


_DTYPES = dict(seg_a=torch.float32, seg_b=torch.float32, beta=torch.float32,
               valid=torch.bool, n=torch.int32, start=torch.float32,
               tex=torch.uint8)


def from_arrays(arrays, device) -> TrackGeometry:
    """TrackGeometry from numpy arrays by field name, cast to the dtypes
    JAX gives them."""
    return TrackGeometry(**{
        k: torch.from_numpy(np.array(arrays[k])).to(
            device=device, dtype=_DTYPES[k])
        for k in TrackGeometry._fields})


def stack(tracks) -> TrackGeometry:
    """A bank (leading axis) from a sequence of single-track geometries."""
    return TrackGeometry(*(torch.stack(f) for f in zip(*tracks)))


def load_or_build_bank(n_unique: int, bake: bool = True,
                       device="cuda") -> TrackGeometry:
    """The bank of tracks 100 .. 100+n_unique-1 (the benchmark banks): read
    from `.cache_tracks/bank{n_unique}_{int(bake)}.npz` when it is there,
    else generated and baked (about 1 s of numpy per baked track)."""
    dev = resolve_device(device)
    path = os.path.join(CACHE_DIR, f"bank{n_unique}_{int(bake)}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return from_arrays({k: z[k] for k in TrackGeometry._fields}, dev)
    return stack([build(make_track(100 + i), bake=bake, device=dev)
                  for i in range(n_unique)])


class SegmentQuery(NamedTuple):
    idx: torch.Tensor      # int64 nearest tile index
    dist: torch.Tensor     # unsigned distance to that segment
    lateral: torch.Tensor  # signed offset (positive = right of travel)
    tangent: torch.Tensor  # (..., 2) unit direction of travel
    closest: torch.Tensor  # (..., 2) closest centerline point


def nearest_segment(bank: TrackGeometry, track_ids: torch.Tensor,
                    p: torch.Tensor) -> SegmentQuery:
    """Nearest centerline segment to each of K points per env.

    p: (B, K, 2); track_ids: (B,). The argmin runs over the P padded
    segments with invalid ones at +inf; ties go to the first index, as
    `jnp.argmin`. Fields are (B, K) or (B, K, 2)."""
    a = bank.seg_a[track_ids][:, None]                     # (B, 1, P, 2)
    b = bank.seg_b[track_ids][:, None]
    ax, ay = a[..., 0], a[..., 1]
    dx, dy = b[..., 0] - ax, b[..., 1] - ay
    l2 = (dx * dx + dy * dy).clamp(min=1e-12)
    px, py = p[..., 0:1], p[..., 1:2]                      # (B, K, 1)
    t = (((px - ax) * dx + (py - ay) * dy) / l2).clamp(0.0, 1.0)
    cl_x, cl_y = ax + t * dx, ay + t * dy
    dd_x, dd_y = px - cl_x, py - cl_y
    dist2 = dd_x * dd_x + dd_y * dd_y
    inf = torch.full_like(dist2, float("inf"))
    dist2 = torch.where(bank.valid[track_ids][:, None], dist2, inf)
    idx = torch.argmin(dist2, dim=-1)                      # (B, K)
    K = p.shape[1]

    def at(x):
        return x.expand(-1, K, -1).gather(-1, idx[..., None])[..., 0]

    dist = sqrt(at(dist2))
    norm = sqrt(at(l2))
    tx, ty = at(dx) / norm, at(dy) / norm
    cross = tx * at(dd_y) - ty * at(dd_x)
    lateral = torch.where(cross > 0, -dist, dist)
    return SegmentQuery(idx, dist, lateral, torch.stack([tx, ty], -1),
                        torch.stack([at(cl_x), at(cl_y)], -1))


def on_road(dist: torch.Tensor) -> torch.Tensor:
    return dist <= TRACK_WIDTH


def sample_texture(bank: TrackGeometry, track_ids: torch.Tensor,
                   p: torch.Tensor):
    """Nearest-texel (base, lane) at world points p (B, ..., 2) of each
    env's track; (0, 0) outside the playfield."""
    tex_size = bank.tex.shape[-1]
    s = tex_size / (2.0 * PLAYFIELD)
    ij = torch.floor((p + PLAYFIELD) * s).to(torch.int64)
    inb = ((ij >= 0) & (ij < tex_size)).all(-1)
    ij = ij.clamp(0, tex_size - 1)
    tid = track_ids.reshape((-1,) + (1,) * (p.dim() - 2)).expand(p.shape[:-1])
    vals = bank.tex[tid, ij[..., 0], ij[..., 1]]
    vals = torch.where(inb, vals, torch.zeros_like(vals))
    return vals // 8, vals % 8
