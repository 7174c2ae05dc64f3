"""Training windows from raw episodes, from their definition (the
reference implementation's `utils/data_utils.py` and `load_data.py`):
sparse strided windows of obs_horizon + pred_horizon rows, step
`step_size`, that fit inside an episode; min-max velocity and action to
[-1, 1] over the whole data; positions min-max with scalar statistics
that are the means of each window's min and max, centred on the window's
first row and halved; frames scaled by 1/255."""

from __future__ import annotations

import numpy as np
import torch


def window_starts(episode_ends, seq_len: int, step: int) -> np.ndarray:
    starts, prev = [], 0
    for end in np.asarray(episode_ends, np.int64):
        last = int(end) - seq_len * step         # start + seq*step <= end
        if last >= prev:
            starts.append(np.arange(prev, last + 1, dtype=np.int64))
        prev = int(end)
    return (np.concatenate(starts) if starts
            else np.zeros((0,), np.int64))


def _minmax_norm(x, lo, hi):
    rng = np.asarray(hi) - np.asarray(lo)
    rng = np.where(rng == 0, 1.0, rng)
    return ((x - lo) / rng) * 2 - 1


class Windows:
    """The windows of `episodes` ({img uint8 (N, 96, 96, 3), position (N,
    2), velocity (N, 2), action (N, 3)} numpy arrays) with `episode_ends`."""

    def __init__(self, episodes: dict, episode_ends, seq_len: int,
                 step: int):
        self.seq_len, self.step = seq_len, step
        self.starts = window_starts(episode_ends, seq_len, step)
        rows = self.starts[:, None] + np.arange(seq_len) * step
        pos = np.asarray(episodes["position"], np.float32)
        w = pos[rows]                                  # (W, seq, 2)
        self.pmin = np.float32(np.mean(w.min(axis=(1, 2))))
        self.pmax = np.float32(np.mean(w.max(axis=(1, 2))))
        vel = np.asarray(episodes["velocity"], np.float32)
        act = np.asarray(episodes["action"], np.float32)
        self.velocity = _minmax_norm(vel, vel.min(0), vel.max(0)).astype(
            np.float32)
        self.action = _minmax_norm(act, act.min(0), act.max(0)).astype(
            np.float32)
        self.position = pos
        self.img = episodes["img"]

    def batch(self, idx, image_frames: int, device) -> dict:
        """{image, position, velocity, action} float32 on `device` for the
        windows `idx`; the first `image_frames` frames of each window."""
        rows = self.starts[np.asarray(idx, np.int64)][:, None] \
            + np.arange(self.seq_len) * self.step
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        img = to(self.img[rows[:, :image_frames]]).float() / 255.0
        rng = float(self.pmax) - float(self.pmin)
        rng = rng if rng != 0 else 1.0
        sn = (to(self.position[rows]) - float(self.pmin)) / rng * 2 - 1
        return {"image": img, "velocity": to(self.velocity[rows]),
                "action": to(self.action[rows]),
                "position": (sn - sn[:, 0:1]) / 2.0}
