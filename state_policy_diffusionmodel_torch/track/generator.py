"""Procedural track generation (host-side numpy).

Reimplements the semantics of `CarRacing._create_track`
(`envs/car_racing.py:194-416`): 12 noisy checkpoints on a
morphed circle, a curvature-limited walk producing the centerline, closed-loop
extraction between two passes of the start angle, a head/tail glue check,
red-white border flags on hard turns, and the repo-specific five "behavior
lane" polylines at fixed lateral offsets.

The loop is data-dependent (retry-until-valid, laps counting), which is why
this stays host-side numpy: a reset costs ~1 ms and is amortized over the
1000-2000 on-device steps of an episode.  The output is a fixed-size padded
`Track` that uploads directly as device tensors (see `geometry.py`).
A copy of `state_policy_diffusionmodel_tpu/track/generator.py`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Reference constants (car_racing.py:58-86).
SCALE = 6.0
TRACK_RAD = 900 / SCALE          # 150
PLAYFIELD = 2000 / SCALE         # 333.33
TRACK_DETAIL_STEP = 21 / SCALE   # 3.5
TRACK_TURN_RATE = 0.31
TRACK_WIDTH = 40 / SCALE         # 6.667
BORDER = 8 / SCALE               # 1.333
BORDER_MIN_COUNT = 4
CHECKPOINTS = 12
ROAD_COLOR = np.array([0.4, 0.4, 0.4])

# Lateral offsets of the 5 behavior lanes (car_racing.py:382-414):
# lleft (grass), left, middle, right, rright (grass).
LANE_OFFSETS = np.array([
    -(TRACK_WIDTH + 2), -(TRACK_WIDTH - 2), 0.0,
    +(TRACK_WIDTH - 2), +(TRACK_WIDTH + 2),
])

MAX_TRACK_PTS = 512              # padded size; real tracks are ~200-320 pts


@dataclasses.dataclass
class Track:
    """One generated track, padded to MAX_TRACK_PTS.

    Segment/tile convention: tile ``i`` spans centerline points
    ``(i-1) % n -> i`` (the reference builds tile i from track[i] and
    track[i-1], including the wraparound at i=0).
    """

    xy: np.ndarray        # (MAX_TRACK_PTS, 2) float32 centerline points
    beta: np.ndarray      # (MAX_TRACK_PTS,)   float32 heading at each point
    border: np.ndarray    # (MAX_TRACK_PTS,)   bool border flag per tile
    n: int                # number of valid points (= number of tiles)
    start: np.ndarray     # (3,) float32 car start: angle(=beta0), x, y
    seed: int

    @property
    def valid(self) -> np.ndarray:
        m = np.zeros(MAX_TRACK_PTS, bool)
        m[: self.n] = True
        return m


def _try_create(rng: np.random.Generator):
    # --- checkpoints ---
    checkpoints = []
    start_alpha = 2 * math.pi * (-0.5) / CHECKPOINTS
    for c in range(CHECKPOINTS):
        noise = rng.uniform(0, 2 * math.pi / CHECKPOINTS)
        alpha = 2 * math.pi * c / CHECKPOINTS + noise
        rad = rng.uniform(TRACK_RAD / 3, TRACK_RAD)
        if c == 0:
            alpha, rad = 0.0, 1.5 * TRACK_RAD
        if c == CHECKPOINTS - 1:
            alpha, rad = 2 * math.pi * c / CHECKPOINTS, 1.5 * TRACK_RAD
        checkpoints.append((alpha, rad * math.cos(alpha), rad * math.sin(alpha)))

    # --- curvature-limited walk from checkpoint to checkpoint ---
    x, y, beta = 1.5 * TRACK_RAD, 0.0, 0.0
    dest_i = 0
    laps = 0
    track = []
    no_freeze = 2500
    visited_other_side = False
    while True:
        alpha = math.atan2(y, x)
        if visited_other_side and alpha > 0:
            laps += 1
            visited_other_side = False
        if alpha < 0:
            visited_other_side = True
            alpha += 2 * math.pi

        while True:  # pick the next destination checkpoint
            failed = True
            while True:
                dest_alpha, dest_x, dest_y = checkpoints[dest_i % CHECKPOINTS]
                if alpha <= dest_alpha:
                    failed = False
                    break
                dest_i += 1
                if dest_i % CHECKPOINTS == 0:
                    break
            if not failed:
                break
            alpha -= 2 * math.pi

        r1x, r1y = math.cos(beta), math.sin(beta)
        p1x, p1y = -r1y, r1x
        proj = r1x * (dest_x - x) + r1y * (dest_y - y)
        while beta - alpha > 1.5 * math.pi:
            beta -= 2 * math.pi
        while beta - alpha < -1.5 * math.pi:
            beta += 2 * math.pi
        prev_beta = beta
        proj *= SCALE
        if proj > 0.3:
            beta -= min(TRACK_TURN_RATE, abs(0.001 * proj))
        if proj < -0.3:
            beta += min(TRACK_TURN_RATE, abs(0.001 * proj))
        x += p1x * TRACK_DETAIL_STEP
        y += p1y * TRACK_DETAIL_STEP
        track.append((alpha, 0.5 * (prev_beta + beta), x, y))
        if laps > 4:
            break
        no_freeze -= 1
        if no_freeze == 0:
            break

    # --- extract the closed loop between two passes of start_alpha ---
    i1, i2 = -1, -1
    i = len(track)
    while True:
        i -= 1
        if i == 0:
            return None  # failed
        pass_through_start = (
            track[i][0] > start_alpha and track[i - 1][0] <= start_alpha
        )
        if pass_through_start and i2 == -1:
            i2 = i
        elif pass_through_start and i1 == -1:
            i1 = i
            break
    track = track[i1 : i2 - 1]
    if len(track) < 2 or len(track) > MAX_TRACK_PTS:
        return None

    # --- head/tail glue check ---
    first_beta = track[0][1]
    fx, fy = math.cos(first_beta), math.sin(first_beta)
    glue = math.sqrt(
        (fx * (track[0][2] - track[-1][2])) ** 2
        + (fy * (track[0][3] - track[-1][3])) ** 2
    )
    if glue > TRACK_DETAIL_STEP:
        return None
    return track


def _border_flags(beta: np.ndarray) -> np.ndarray:
    """Red-white border on hard turns (car_racing.py:311-325), with the
    reference's python negative-index wraparound semantics."""
    n = len(beta)
    border = np.zeros(n, bool)
    for i in range(n):
        good = True
        oneside = 0
        for neg in range(BORDER_MIN_COUNT):
            b1 = beta[(i - neg) % n]
            b2 = beta[(i - neg - 1) % n]
            good &= abs(b1 - b2) > TRACK_TURN_RATE * 0.2
            oneside += np.sign(b1 - b2)
        good &= abs(oneside) == BORDER_MIN_COUNT
        border[i] = good
    out = border.copy()
    for i in range(n):
        if border[i]:
            for neg in range(BORDER_MIN_COUNT):
                out[(i - neg) % n] = True
    return out


def make_track(seed: int, max_retries: int = 100) -> Track:
    """Generate one track, retrying until valid (car_racing.py:436-443)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_retries):
        raw = _try_create(rng)
        if raw is not None:
            break
    else:
        raise RuntimeError(f"track generation failed after {max_retries} tries")

    arr = np.asarray(raw, np.float64)  # (n, 4): alpha, beta, x, y
    n = len(arr)
    xy = np.zeros((MAX_TRACK_PTS, 2), np.float32)
    beta = np.zeros(MAX_TRACK_PTS, np.float32)
    border = np.zeros(MAX_TRACK_PTS, bool)
    xy[:n] = arr[:, 2:4]
    beta[:n] = arr[:, 1]
    border[:n] = _border_flags(arr[:, 1])
    start = np.asarray([arr[0, 1], arr[0, 2], arr[0, 3]], np.float32)
    return Track(xy=xy, beta=beta, border=border, n=n, start=start, seed=seed)


def lane_points(track: Track) -> np.ndarray:
    """(5, n, 2) lane polylines at the reference lateral offsets.

    The reference appends n+1 points using python index -1 wraparound
    (car_racing.py:383-414): the strip starts at the last track point and then
    walks 0..n-1, closing the loop.
    """
    n = track.n
    u = np.stack([np.cos(track.beta[:n]), np.sin(track.beta[:n])], -1)  # (n,2)
    pts = track.xy[:n]
    lanes = pts[None, :, :] + LANE_OFFSETS[:, None, None] * u[None, :, :]
    # include the wraparound start point so the polyline closes
    return np.concatenate([lanes[:, -1:, :], lanes], axis=1).astype(np.float32)


def tile_quads(track: Track) -> np.ndarray:
    """(n, 4, 2) road tile quads [l1, r1, r2, l2] for tile i spanning point
    (i-1)%n -> i (car_racing.py:327-357)."""
    n = track.n
    pts, beta = track.xy[:n], track.beta[:n]
    u = np.stack([np.cos(beta), np.sin(beta)], -1)
    l1 = pts - TRACK_WIDTH * u
    r1 = pts + TRACK_WIDTH * u
    l2 = np.roll(l1, 1, axis=0)
    r2 = np.roll(r1, 1, axis=0)
    return np.stack([l1, r1, r2, l2], axis=1).astype(np.float32)
