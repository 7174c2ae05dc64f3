"""The 96x96 rasterizer of the CarRacing state image, batched over envs.

Counterpart of `state_policy_diffusionmodel_tpu/render/raster.py`, with its
layout: every per-pixel quantity is a flat (72, 128) plane (9216 = 96 * 96
pixels, row-major), here with a leading env axis B. Each layer (grass
checker, road texels, lanes, the predicted-points overlay, 12 car polygons,
the HUD bar and its 7 indicator quads, the score digits) becomes a plane of
palette indices; later layers have larger indices, so the draw order is an
elementwise max, and colour is a palette lookup at the end.

The texel fetch is kernel K2 (`cuda_sampler.sample_banked`), on the card a
CUDA kernel; it is the only texel path. The JAX file keeps two formulations
each of colorize and of the score; this one has one of each: a palette
lookup `PALETTE_U8[layer]` and a gather of the 7-segment glyph table.

The pixel -> world map and the polygon edge test keep the JAX operation
order; the constant pixel planes are computed once on the CPU and copied to
each device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..physics import CarState, constants as C, hull_com_velocity
from ..physics.car import div, rotate_rows, sqrt, wheel_positions
from ..track import texture as textures
from ..track.generator import PLAYFIELD
from . import camera
from . import cuda_sampler

F32 = torch.float32
FLAT = (72, 128)  # 9216 = 96 * 96 pixels

# ---------------------------------------------------------------------------
# static car polygon table (body frame), padded to (NPOLY, MAXV, 2)
# ---------------------------------------------------------------------------
MAXV = 8


def _pad(poly):
    v = np.asarray(poly, np.float32) * C.SIZE
    out = np.zeros((MAXV, 2), np.float32)
    out[:len(v)] = v
    out[len(v):] = v[-1]  # repeated last vertex: degenerate edges
    return out


HULL_POLYS = np.stack([
    _pad(C.HULL_POLY1), _pad(C.HULL_POLY2), _pad(C.HULL_POLY3),
    _pad(C.HULL_POLY4)])  # (4, 8, 2)

WHEEL_POLY = _pad([
    (-C.WHEEL_W, +C.WHEEL_R), (+C.WHEEL_W, +C.WHEEL_R),
    (+C.WHEEL_W, -C.WHEEL_R), (-C.WHEEL_W, -C.WHEEL_R),
])  # (8, 2)

HULL_COLOR = np.array([0.8, 0.0, 0.0], np.float32)
WHEEL_COLOR = np.array([0.0, 0.0, 0.0], np.float32)
WHEEL_WHITE = np.array([0.3, 0.3, 0.3], np.float32)
POINTS_COLOR = np.array([1.0, 0.0, 0.0], np.float32)

GRASS_K = PLAYFIELD / 20.0

# Static flat-row bands: the car-locked camera puts every car vertex on
# image rows [66, 78], so the car polygons are tested on flat rows 45..63
# only; the HUD bar and its quads lie on flat rows 50..72; the score label
# on flat rows 65..69 (raster.py of the JAX package derives each band).
CAR_ROWS = (45, 63)
HUD_ROWS = (50, 72)
SCORE_ROWS = (65, 70)

# HUD indicator colours in draw order (car_racing.py:713-773)
HUD_COLORS = np.array([
    [1.0, 1.0, 1.0],    # true speed
    [0.0, 0.0, 1.0],    # wheel omega 0
    [0.0, 0.0, 1.0],    # wheel omega 1
    [0.2, 0.0, 1.0],    # wheel omega 2
    [0.2, 0.0, 1.0],    # wheel omega 3
    [0.0, 1.0, 0.0],    # steering joint angle
    [1.0, 0.0, 0.0],    # angular velocity
], np.float32)

# ---------------------------------------------------------------------------
# layer palette: index = draw order; composition = elementwise max
# ---------------------------------------------------------------------------
L_OUTFIELD = 0
L_GRASS_DARK = 1
L_GRASS_LIGHT = 2
L_BASE0 = 3          # 3..7: road shades / borders (texture base 1..5)
L_LANE0 = 8          # 8..12: behavior lanes (texture lane 1..5, augm only)
N_LANES = 5
L_POINTS = 13
L_CAR0 = 14          # 14..25: wheel0, rim0, ..., hull1..4 in draw order
L_HUD_BAR = 26
L_HUD0 = 27          # 27..33: indicator quads
L_SCORE = 34         # score digits (drawn last, car_racing.py:774-775)
N_LAYERS = 64


def _u8(c):
    """round(clip(c, 0, 1) * 255) in float32, round-half-even."""
    c = np.clip(np.asarray(c, np.float32), 0, 1) * np.float32(255)
    return np.round(c).astype(np.uint8)


def _build_palette() -> np.ndarray:
    pal = np.zeros((N_LAYERS, 3), np.uint8)
    pal[L_OUTFIELD] = _u8(textures.OUTFIELD)
    pal[L_GRASS_DARK] = _u8(textures.GRASS_DARK)
    pal[L_GRASS_LIGHT] = _u8(textures.GRASS_LIGHT)
    pal[L_BASE0:L_BASE0 + 5] = _u8(textures.BASE_PALETTE[1:6])
    pal[L_LANE0:L_LANE0 + 5] = _u8(textures.LANE_PALETTE[1:6])
    pal[L_POINTS] = _u8(POINTS_COLOR)
    for k in range(4):
        pal[L_CAR0 + 2 * k] = _u8(WHEEL_COLOR)
        pal[L_CAR0 + 2 * k + 1] = _u8(WHEEL_WHITE)
    pal[L_CAR0 + 8:L_CAR0 + 12] = _u8(HULL_COLOR)
    pal[L_HUD_BAR] = 0
    pal[L_HUD0:L_HUD0 + 7] = _u8(HUD_COLORS)
    pal[L_SCORE] = 255                      # white, car_racing.py:511
    return pal


PALETTE_U8 = _build_palette()


class Overlay(NamedTuple):
    """Predicted-trajectory polylines (`add_points2Buffer`,
    car_racing.py:704-710), world frame, drawn red in every env's frame."""

    points: torch.Tensor   # (K, L, 2)
    valid: torch.Tensor    # (K,) bool


def _pixel_planes_cpu():
    """(wx, wy, rx, ry), each (72, 128) float32: window coordinates of each
    pixel centre and the camera-frame coordinates divided by the zoom,
    computed as `raster._pixel_planes` of the JAX package does."""
    p = torch.arange(FLAT[0] * FLAT[1]).reshape(FLAT)
    r = p // camera.STATE_W
    c = p % camera.STATE_W
    wx = (c + 0.5) * (camera.WINDOW_W / camera.STATE_W)
    wy = (camera.STATE_H - 1 - r + 0.5) * (camera.WINDOW_H / camera.STATE_H)
    rx = (wx - camera.WINDOW_W / 2) / camera.CAM_ZOOM
    ry = (wy - camera.WINDOW_H / 4) / camera.CAM_ZOOM
    return wx, wy, rx, ry


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The constant planes and tables, copied once to `device`."""
    planes = tuple(t.to(device) for t in _pixel_planes_cpu())
    return dict(
        planes=planes,
        # rows past N_LAYERS are black, as the JAX one-hot colorize makes
        # an index it has no row for: two neighbouring score glyphs can
        # both light a pixel, and their sum 2 * L_SCORE is such an index
        palette=torch.from_numpy(np.concatenate(
            [PALETTE_U8, np.zeros((2 * L_SCORE + 1 - N_LAYERS, 3),
                                  np.uint8)])).to(device),
        hull=torch.from_numpy(HULL_POLYS).to(device),
        wheel=torch.from_numpy(WHEEL_POLY).to(device),
        score=torch.from_numpy(_SCORE_VALUES.astype(np.int32)).to(device),
    )


def pixel_planes(device) -> tuple:
    return _device_tables(torch.device(device))["planes"]


def _world_planes(cars: CarState, angle: torch.Tensor, rx, ry):
    """(B, 72, 128) world coordinates of every pixel: px = (c*rx + s*ry) +
    x, py = ((-s)*rx + c*ry) + y, in that order."""
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    px = c * rx + s * ry + cars.pos[:, 0, None, None]
    py = -s * rx + c * ry + cars.pos[:, 1, None, None]
    return px, py


def _background_layer(px, py):
    """Grass checker / out-of-field white (car_racing.py:608-644 and the GL
    clear colour) as palette indices."""
    infield = (px.abs() <= PLAYFIELD) & (py.abs() <= PLAYFIELD)
    ix = torch.floor(div(px, GRASS_K)).to(torch.int32)
    iy = torch.floor(div(py, GRASS_K)).to(torch.int32)
    light = (ix % 2 == 0) & (iy % 2 == 0)
    grass = torch.where(light, L_GRASS_LIGHT, L_GRASS_DARK).to(torch.int32)
    return torch.where(infield, grass, L_OUTFIELD).to(torch.int32)


def _poly_layers(px, py, verts, active, layer0, counts=None, winding=None):
    """Fold convex polygons into a layer-index plane by draw order.

    px, py: (B, R, 128); verts: (B, N, MAXV, 2) world frame; active (B, N).
    Polygon i gets index layer0 + i where the reference renderer's epsilon
    cross-product test passes on every edge: cross = e0 * (py - ay) -
    e1 * (px - ax) against +-1e-6, in this operation order. `counts` are the
    static vertex counts; `winding` is 'cw', 'ccw' or 'both' per polygon
    (rigid motions keep orientation; the wheel rims flip with the phase).
    The edges of one polygon are evaluated together: max and min do not
    depend on the order they reduce in."""
    n, nv = verts.shape[1], verts.shape[2]
    counts = counts or (nv,) * n
    winding = winding or ("both",) * n
    layer = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    pxe, pye = px[:, None], py[:, None]                     # (B, 1, R, 128)
    for i in range(n):
        k = counts[i]
        v = verts[:, i, :k]                                 # (B, k, 2)
        nxt = torch.roll(v, -1, dims=1)
        ax = v[:, :, 0, None, None]
        ay = v[:, :, 1, None, None]
        e0 = nxt[:, :, 0, None, None] - ax
        e1 = nxt[:, :, 1, None, None] - ay
        cross = e0 * (pye - ay) - e1 * (pxe - ax)           # (B, k, R, 128)
        if winding[i] == "cw":
            inside = cross.amax(1) <= 1e-6
        elif winding[i] == "ccw":
            inside = cross.amin(1) >= -1e-6
        else:
            inside = (cross.amax(1) <= 1e-6) | (cross.amin(1) >= -1e-6)
        on = inside & active[:, i, None, None]
        layer = torch.where(on, torch.full_like(layer, layer0 + i), layer)
    return layer


# car polygon metadata (draw order wheel0, rim0, ..., hull1..4)
CAR_COUNTS = (4, 4) * 4 + tuple(
    len(p) for p in (C.HULL_POLY1, C.HULL_POLY2, C.HULL_POLY3, C.HULL_POLY4))
CAR_WINDING = ("cw", "both") * 4 + ("cw", "cw", "cw", "ccw")


def _wheel_stripes(phase: torch.Tensor):
    """White rim quads of the wheels in wheel frame (car_dynamics.py:332-352):
    phase (B, 4) -> verts (B, 4, 4, 2), active (B, 4)."""
    a1, a2 = phase, phase + 1.2
    s1, s2 = torch.sin(a1), torch.sin(a2)
    c1, c2 = torch.cos(a1), torch.cos(a2)
    active = ~((s1 > 0) & (s2 > 0))
    c1 = torch.where(s1 > 0, torch.sign(c1), c1)
    c2 = torch.where(s2 > 0, torch.sign(c2), c2)
    w, r = C.WHEEL_W * C.SIZE, C.WHEEL_R * C.SIZE
    mw = torch.full_like(c1, -w)
    pw = torch.full_like(c1, w)
    y1, y2 = r * c1, r * c2
    verts = torch.stack([torch.stack([mw, y1], -1), torch.stack([pw, y1], -1),
                         torch.stack([pw, y2], -1), torch.stack([mw, y2], -1)],
                        2)
    return verts, active


def _car_polys(cars: CarState):
    """All car polygons in world frame, reference draw order (wheels and
    rims first, hull last): verts (B, 12, 8, 2), active (B, 12)."""
    tab = _device_tables(cars.pos.device)
    B = cars.pos.shape[0]
    c = torch.cos(cars.angle)[:, None, None]
    s = torch.sin(cars.angle)[:, None, None]
    # HULL_POLYS @ rot.T + pos
    hv = tab["hull"]                                       # (4, 8, 2)
    hull_world = torch.stack(rotate_rows(hv[..., 0], hv[..., 1], c, s), -1) \
        + cars.pos[:, None, None]                          # (B, 4, 8, 2)
    wp = wheel_positions(cars.pos.device)                  # (4, 2)
    wheel_pos = torch.stack(rotate_rows(wp[:, 0], wp[:, 1], c[:, :, 0],
                                        s[:, :, 0]), -1) \
        + cars.pos[:, None]                                # (B, 4, 2)
    wheel_angle = cars.angle[:, None] + cars.joint_angle   # (B, 4)
    wc = torch.cos(wheel_angle)[..., None]
    ws = torch.sin(wheel_angle)[..., None]

    def to_world(v_body):                                  # (B, 4, V, 2)
        x, y = v_body[..., 0], v_body[..., 1]
        return torch.stack([wc * x - ws * y, ws * x + wc * y], -1) \
            + wheel_pos[:, :, None]

    wheel_world = to_world(tab["wheel"].expand(B, 4, MAXV, 2))
    stripes, stripe_active = _wheel_stripes(cars.phase)    # (B, 4, 4, 2)
    stripes = torch.cat([stripes, stripes[:, :, -1:].expand(
        -1, -1, MAXV - 4, -1)], 2)
    stripe_world = to_world(stripes)
    verts = torch.cat([torch.stack([wheel_world, stripe_world], 2)
                       .reshape(B, 8, MAXV, 2), hull_world], 1)
    ones = torch.ones((B, 4), dtype=torch.bool, device=cars.pos.device)
    active = torch.cat([torch.stack([ones, stripe_active], 2).reshape(B, 8),
                        ones], 1)
    return verts, active


def _indicator_bounds(cars: CarState, hull_vel: torch.Tensor):
    """HUD indicator rectangles in window coordinates (car_racing.py:713-773)
    as (x0, x1, y0, y1), each (B, 7): the min and max of each quad's
    corners."""
    s, h = camera.WINDOW_W / 40.0, camera.WINDOW_H / 40.0
    true_speed = sqrt(hull_vel[:, 0] * hull_vel[:, 0]
                            + hull_vel[:, 1] * hull_vel[:, 1])
    vert_vals = [0.02 * true_speed] + [0.01 * cars.omega[:, k]
                                       for k in range(4)]
    x0, x1, y0, y1 = [], [], [], []
    for place, val in zip((5.0, 7.0, 8.0, 9.0, 10.0), vert_vals):
        top = h + h * val
        base = torch.full_like(top, h)
        x0.append(torch.full_like(top, place * s))
        x1.append(torch.full_like(top, (place + 1) * s))
        y0.append(torch.minimum(top, base))
        y1.append(torch.maximum(top, base))
    for place, val in ((20.0, -10.0 * cars.joint_angle[:, 0]),
                       (30.0, -0.8 * cars.angular_vel)):
        a = torch.full_like(val, place * s)
        b = (place + val) * s
        x0.append(torch.minimum(a, b))
        x1.append(torch.maximum(a, b))
        y0.append(torch.full_like(val, 2 * h))
        y1.append(torch.full_like(val, 4 * h))
    return tuple(torch.stack(v, 1) for v in (x0, x1, y0, y1))


def _hud_layer(wx, wy, cars: CarState, hull_vel):
    """HUD bar and indicator quads as a (B, rows, 128) layer plane: the
    quads are axis-aligned, so the inside test is four compares."""
    x0, x1, y0, y1 = (v[:, :, None, None]
                      for v in _indicator_bounds(cars, hull_vel))
    B = hull_vel.shape[0]
    bar = (wy <= 5 * (camera.WINDOW_H / 40.0)).to(torch.int32) * L_HUD_BAR
    layer = bar.expand(B, -1, -1)
    for i in range(7):
        inside = ((wx >= x0[:, i]) & (wx <= x1[:, i]) &
                  (wy >= y0[:, i]) & (wy <= y1[:, i]))
        layer = torch.where(inside, torch.full_like(layer, L_HUD0 + i), layer)
    return layer


# 7-segment glyphs of the score label "%04i" (font_size 36 at window
# (20, 50), car_racing.py:504-512,774): segment rectangles (u0, u1, v0, v1)
# in a 16x25 cell; order top, top-right, bottom-right, bottom, bottom-left,
# top-left, middle.
_SCORE_X0, _SCORE_ADV, _SCORE_Y0 = 20.0, 20.0, 37.5
_SEG_T = 4.5
_SEG_RECTS = np.array([
    (1.0, 15.0, 25.0 - _SEG_T, 25.0),
    (16.0 - _SEG_T, 16.0, 12.5, 25.0),
    (16.0 - _SEG_T, 16.0, 0.0, 12.5),
    (1.0, 15.0, 0.0, _SEG_T),
    (0.0, _SEG_T, 0.0, 12.5),
    (0.0, _SEG_T, 12.5, 25.0),
    (1.0, 15.0, 12.5 - _SEG_T / 2, 12.5 + _SEG_T / 2),
], np.float32)
# per-char segment bitmasks: digits 0-9 then '-' (index 10)
_SEG_BITS = np.array([63, 6, 91, 79, 102, 109, 125, 7, 127, 111, 64],
                     np.int32)


def _score_chars(score: torch.Tensor) -> torch.Tensor:
    """(B, 4) glyphs of `"%04i" % score` (digit value, or 10 for '-')."""
    val = torch.trunc(score).to(torch.int32)      # C %i truncates toward 0
    a = val.abs()
    d = torch.stack([(a // 1000) % 10, (a // 100) % 10, (a // 10) % 10,
                     a % 10], -1)
    minus = torch.full_like(d[:, :1], 10)
    return torch.where((val < 0)[:, None], torch.cat([minus, d[:, 1:]], 1), d)


def _score_coverage_table() -> np.ndarray:
    """(4 slots, 11 glyphs, score rows, 128) uint8 counts of the 4x4
    subsamples of each pixel that a glyph covers, in float32."""
    i0, i1 = SCORE_ROWS
    p = np.arange(i0 * 128, i1 * 128)
    r = (p // camera.STATE_W).astype(np.float32)
    c = (p % camera.STATE_W).astype(np.float32)
    wx = (c + 0.5) * np.float32(camera.WINDOW_W / camera.STATE_W)
    wy = (camera.STATE_H - 1 - r + 0.5) * np.float32(
        camera.WINDOW_H / camera.STATE_H)
    offs = ((np.arange(4, dtype=np.float32) + 0.5) / 4.0 - 0.5)
    sx = wx[None] + (np.repeat(offs, 4)[:, None]
                     * np.float32(camera.WINDOW_W / camera.STATE_W))
    sy = wy[None] + (np.tile(offs, 4)[:, None]
                     * np.float32(camera.WINDOW_H / camera.STATE_H))
    gx = sx - np.float32(_SCORE_X0)
    slot = np.floor(gx / np.float32(_SCORE_ADV)).astype(np.int32)
    u = gx - slot.astype(np.float32) * np.float32(_SCORE_ADV)
    v = sy - np.float32(_SCORE_Y0)
    table = np.zeros((4, 11, len(p)), np.uint8)
    for s in range(4):
        for ch in range(11):
            bits = int(_SEG_BITS[ch])
            inside = np.zeros_like(sx, bool)
            for j, (u0, u1, v0, v1) in enumerate(_SEG_RECTS):
                if (bits >> j) & 1:
                    inside |= ((u >= u0) & (u <= u1) & (v >= v0) & (v <= v1))
            inside &= slot == s
            table[s, ch] = inside.sum(0)
    return table.reshape(4, 11, i1 - i0, 128)


def _score_value_table() -> np.ndarray:
    """(4, 11, HUD rows, 128): L_SCORE where a glyph covers at least 4 of a
    pixel's 16 subsamples, 0 elsewhere, padded to the HUD band."""
    h0, h1 = HUD_ROWS
    s0, s1 = SCORE_ROWS
    t = np.zeros((4, 11, h1 - h0, 128), np.uint8)
    t[:, :, s0 - h0:s1 - h0] = (_score_coverage_table() >= 4) * np.uint8(
        L_SCORE)
    return t


_SCORE_VALUES = _score_value_table()


def _score_band(score: torch.Tensor) -> torch.Tensor:
    """(B, HUD rows, 128) score layer: the four slots' glyph planes summed
    (slots light disjoint columns, as the JAX one-hot dot sums them)."""
    table = _device_tables(score.device)["score"]          # (4, 11, R, 128)
    chars = _score_chars(score)                            # (B, 4)
    return sum(table[k][chars[:, k]] for k in range(4))


def _overlay_layer(overlay: Overlay, wx, wy, scroll, angle):
    """Predicted-points polylines as a (B, 72, 128) layer plane
    (car_racing.py:691-701): red segments 1 px wide in state-pixel space.
    Segments go in chunks sized to bound the (B, chunk, 72, 128) working
    set; hits are OR-ed, so the chunking does not change the result."""
    a = overlay.points[:, :-1].reshape(-1, 2)
    b = overlay.points[:, 1:].reshape(-1, 2)
    seg_ok = overlay.valid[:, None].expand(
        -1, overlay.points.shape[1] - 1).reshape(-1)
    dev = wx.device
    sx = torch.tensor(camera.STATE_W / camera.WINDOW_W, dtype=F32, device=dev)
    sy = torch.tensor(camera.STATE_H / camera.WINDOW_H, dtype=F32, device=dev)
    aw = camera.world_to_window(a[None], scroll[:, None], angle[:, None])
    bw = camera.world_to_window(b[None], scroll[:, None], angle[:, None])
    awx, awy = aw[..., 0] * sx, aw[..., 1] * sy             # (B, S)
    bwx, bwy = bw[..., 0] * sx, bw[..., 1] * sy
    pfx, pfy = wx * sx, wy * sy
    B, S = awx.shape
    chunk = max(1, (1 << 24) // (B * FLAT[0] * FLAT[1]))
    hit = torch.zeros((B,) + FLAT, dtype=torch.bool, device=dev)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        ax, ay = awx[:, sl, None, None], awy[:, sl, None, None]
        dx = bwx[:, sl, None, None] - ax
        dy = bwy[:, sl, None, None] - ay
        l2 = (dx * dx + dy * dy).clamp(min=1e-9)
        apx, apy = pfx - ax, pfy - ay
        t = ((apx * dx + apy * dy) / l2).clamp(0.0, 1.0)
        cx, cy = apx - t * dx, apy - t * dy
        near = (cx * cx + cy * cy <= 0.5 ** 2) & seg_ok[sl, None, None]
        hit |= near.any(1)
    return hit.to(torch.int32) * L_POINTS


def _compose(cars: CarState, base_idx, lane_idx,
             overlay: Optional[Overlay] = None,
             score: Optional[torch.Tensor] = None):
    """Everything after the texel fetch: layers, draw order and colour.
    base_idx, lane_idx: (B, 72, 128). Returns (state, augmented) frames,
    (B, 96, 96, 3) uint8 each."""
    tab = _device_tables(cars.pos.device)
    wx, wy, rx, ry = tab["planes"]
    hull_vel = hull_com_velocity(cars)
    angle = camera.camera_angle(cars.angle, hull_vel)
    px, py = _world_planes(cars, angle, rx, ry)
    B = px.shape[0]

    zero = torch.zeros_like(base_idx)
    layer = _background_layer(px, py)
    layer = torch.maximum(layer, torch.where(base_idx > 0,
                                             base_idx + (L_BASE0 - 1), zero))
    lane_term = torch.where(lane_idx > 0, lane_idx + (L_LANE0 - 1), zero)
    if overlay is not None:
        layer = torch.maximum(layer, _overlay_layer(overlay, wx, wy,
                                                    cars.pos, angle))

    verts, active = _car_polys(cars)
    c0, c1 = CAR_ROWS
    car_band = _poly_layers(px[:, c0:c1], py[:, c0:c1], verts, active,
                            L_CAR0, CAR_COUNTS, CAR_WINDING)
    layer[:, c0:c1] = torch.maximum(layer[:, c0:c1], car_band)

    h0, h1 = HUD_ROWS
    hud_band = _hud_layer(wx[h0:h1], wy[h0:h1], cars, hull_vel)
    if score is not None:
        hud_band = torch.maximum(hud_band, _score_band(score))
    layer[:, h0:h1] = torch.maximum(layer[:, h0:h1], hud_band)

    pal = tab["palette"]
    shape = (B, camera.STATE_H, camera.STATE_W, 3)
    state_rgb = pal[layer].reshape(shape)
    # lanes sit above road and grass and below everything else: the
    # augmented frame differs from the state frame only where a lane wins
    augm_rgb = torch.where((lane_term > layer)[..., None], pal[lane_term],
                           pal[layer]).reshape(shape)
    return state_rgb, augm_rgb


def render_batch_banked(cars: CarState, tex_bank: torch.Tensor,
                        track_ids: torch.Tensor,
                        overlay: Optional[Overlay] = None,
                        score: Optional[torch.Tensor] = None):
    """Render B envs against a bank of track textures: cars batched (B, ...),
    tex_bank (U, T, T) uint8, track_ids (B,) int32, score (B,) or None.
    The texel fetch is one K2 launch for the batch."""
    _, _, rx, ry = _device_tables(cars.pos.device)["planes"]
    vals = cuda_sampler.sample_banked(tex_bank, track_ids.to(torch.int32),
                                      *camera_scalars(cars), rx, ry)
    return _compose(cars, vals // 8, vals % 8, overlay, score)


def camera_scalars(cars: CarState):
    """(cos, sin, pos) of each env's camera: the K2 inputs besides the
    bank, the track ids and the constant planes."""
    angle = camera.camera_angle(cars.angle, hull_com_velocity(cars))
    return torch.cos(angle), torch.sin(angle), cars.pos.contiguous()


def render(cars: CarState, geoms, track_ids=None,
           overlay: Optional[Overlay] = None,
           score: Optional[torch.Tensor] = None):
    """Render B envs from a track bank `geoms` (a TrackGeometry with a
    leading axis); track_ids defaults to arange(B), one track per env."""
    if track_ids is None:
        track_ids = torch.arange(cars.pos.shape[0], dtype=torch.int32,
                                 device=cars.pos.device)
    return render_batch_banked(cars, geoms.tex, track_ids, overlay, score)
