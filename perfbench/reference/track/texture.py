"""Host-side bake of the per-track world-space palette texture.

The reference rasterizes the whole scene with OpenGL every step
(`envs/car_racing.py:498-599`, two framebuffer passes +
glReadPixels).  Here everything static per track (road tiles,
borders, behavior lanes) is baked ONCE per reset into a palette-indexed
world-space texture; the per-step renderer is then a camera-transformed
gather (see `render/`).  One byte per texel holds the base palette index and
a second byte the lane index, so the normal and augmented frames
(car_racing.py:577-599) come from the same texture under two palettes.

Draw order matches the GL pass: tiles in index order, each tile's border quad
after it, lanes after all road (later draws win).
A copy of `state_policy_diffusionmodel_tpu/track/texture.py`.
"""

from __future__ import annotations

import numpy as np

from .generator import (
    BORDER, LANE_OFFSETS, PLAYFIELD, TRACK_WIDTH, Track, tile_quads,
)

# base palette indices
BG = 0          # background: analytic grass / out-of-field (not stored)
ROAD0 = 1       # road shade 0.40 + 0.01 * (i % 3)
ROAD1 = 2
ROAD2 = 3
BORDER_WHITE = 4
BORDER_RED = 5

# float RGB palette for the base channel (car_racing.py:86,353,378 + grass
# colors at :609,626 and the white GL clear color outside the playfield).
BASE_PALETTE = np.array([
    [0.0, 0.0, 0.0],        # BG placeholder (renderer computes grass)
    [0.40, 0.40, 0.40],
    [0.41, 0.41, 0.41],
    [0.42, 0.42, 0.42],
    [1.0, 1.0, 1.0],
    [1.0, 0.0, 0.0],
], np.float32)

# lane palette (car_racing.py:662-676): yellow, cyan, magenta, purple, blue.
LANE_PALETTE = np.array([
    [0.0, 0.0, 0.0],        # 0 = no lane
    [1.0, 1.0, 0.0],
    [0.0, 1.0, 1.0],
    [1.0, 0.0, 1.0],
    [0.5, 0.1, 0.5],
    [0.0, 0.0, 1.0],
], np.float32)

GRASS_DARK = np.array([0.4, 0.8, 0.4], np.float32)
GRASS_LIGHT = np.array([0.4, 0.9, 0.4], np.float32)
OUTFIELD = np.array([1.0, 1.0, 1.0], np.float32)  # GL clear color

# GL_LINE width 3 on the 96px framebuffer ~= 1.93 world units
# (zoom*96/WINDOW_W = 1.555 px per unit); half-width in world units:
LANE_HALF_WIDTH = 1.0

DEFAULT_TEX = 1024


def world_to_texel_scale(tex_size: int) -> float:
    return tex_size / (2.0 * PLAYFIELD)


def _point_in_tri(px, py, a, b, c):
    d1 = (px - b[0]) * (a[1] - b[1]) - (a[0] - b[0]) * (py - b[1])
    d2 = (px - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (py - c[1])
    d3 = (px - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (py - a[1])
    neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(neg & pos)


def _point_in_quad(px, py, quad):
    return _point_in_tri(px, py, quad[0], quad[1], quad[2]) | _point_in_tri(
        px, py, quad[0], quad[2], quad[3]
    )


def _patch_grid(quads, tex_size, margin=2.0):
    """Texel-index bbox and world coords of texel centers covering `quads`."""
    allq = np.concatenate([q.reshape(-1, 2) for q in quads], 0)
    s = world_to_texel_scale(tex_size)
    lo = np.floor((allq.min(0) - margin + PLAYFIELD) * s).astype(int)
    hi = np.ceil((allq.max(0) + margin + PLAYFIELD) * s).astype(int) + 1
    lo = np.clip(lo, 0, tex_size)
    hi = np.clip(hi, 0, tex_size)
    ix = np.arange(lo[0], hi[0])
    iy = np.arange(lo[1], hi[1])
    wx = (ix + 0.5) / s - PLAYFIELD
    wy = (iy + 0.5) / s - PLAYFIELD
    px, py = np.meshgrid(wx, wy, indexing="ij")
    return (slice(lo[0], hi[0]), slice(lo[1], hi[1])), px, py


def bake_texture(track: Track, tex_size: int = DEFAULT_TEX) -> np.ndarray:
    """(tex_size, tex_size, 2) uint8: [:, :, 0]=base index, [:, :, 1]=lane.

    Texture axes are (x, y) world; texel (i, j) covers world
    [i/s - PF, (i+1)/s - PF) x [j/s - PF, ...).
    """
    n = track.n
    tex = np.zeros((tex_size, tex_size, 2), np.uint8)
    quads = tile_quads(track)                       # (n,4,2)
    pts, beta = track.xy[:n], track.beta[:n]
    u = np.stack([np.cos(beta), np.sin(beta)], -1)  # lateral unit vector

    # --- road tiles + borders, in draw order ---
    for i in range(n):
        q = quads[i]
        draw = [(q, ROAD0 + i % 3)]
        if track.border[i]:
            j = (i - 1) % n
            side = np.sign(beta[j] - beta[i])
            if side == 0:
                side = 1.0
            b1l = pts[i] + side * TRACK_WIDTH * u[i]
            b1r = pts[i] + side * (TRACK_WIDTH + BORDER) * u[i]
            b2l = pts[j] + side * TRACK_WIDTH * u[j]
            b2r = pts[j] + side * (TRACK_WIDTH + BORDER) * u[j]
            color = BORDER_WHITE if i % 2 == 0 else BORDER_RED
            draw.append((np.stack([b1l, b1r, b2r, b2l]), color))
        (sx, sy), px, py = _patch_grid([d[0] for d in draw], tex_size)
        if px.size == 0:
            continue
        region = tex[sx, sy, 0]
        for quad, color in draw:
            inside = _point_in_quad(px, py, quad)
            region = np.where(inside, color, region)
        tex[sx, sy, 0] = region

    # --- behavior lanes into the lane channel ---
    for lane_idx in range(5):
        off = LANE_OFFSETS[lane_idx]
        lane = pts + off * u                        # (n,2)
        a = np.roll(lane, 1, axis=0)                # closed loop segments
        for i in range(n):
            seg_a, seg_b = a[i], lane[i]
            bbox = np.stack([seg_a, seg_b])
            (sx, sy), px, py = _patch_grid([bbox], tex_size,
                                           margin=LANE_HALF_WIDTH + 1.5)
            if px.size == 0:
                continue
            d = seg_b - seg_a
            L2 = max(float(d @ d), 1e-12)
            t = np.clip(((px - seg_a[0]) * d[0] + (py - seg_a[1]) * d[1]) / L2, 0, 1)
            cx = seg_a[0] + t * d[0]
            cy = seg_a[1] + t * d[1]
            dist2 = (px - cx) ** 2 + (py - cy) ** 2
            inside = dist2 <= LANE_HALF_WIDTH**2
            region = tex[sx, sy, 1]
            tex[sx, sy, 1] = np.where(inside, lane_idx + 1, region)
    return tex
