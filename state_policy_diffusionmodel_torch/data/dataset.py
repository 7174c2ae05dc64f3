"""Windowed dataset + data module for diffusion-policy training.

Counterpart of `state_policy_diffusionmodel_tpu/data/dataset.py`, with the
same windows, statistics, split and sidecar: sparse strided windows over
zarr episodes, min-max action/velocity normalization, the per-window
position centering, the averaged-window position stats quirk, the 80/20
seeded split and the `STATS.pkl` sidecar. Images stay NHWC.

Host batches are assembled by the port's host library (`data/native.py`:
a multithreaded C++ window gather and position normalization, built with
g++ at the first batch), as the JAX package's `WindowDataset.batch` does
where its C++ sampler is built. `gather_windows` and `normalize_positions`
below are the numpy plain versions, which the library equals bit for bit.
The device twin, `DeviceWindowDataset`, keeps the dataset on the card and
gathers windows with torch ops.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from . import native
from . import normalize as N
from .replay_buffer import ReplayBuffer, load_zarr


def gather_windows(src: np.ndarray, starts: np.ndarray, seq_len: int,
                   step: int) -> np.ndarray:
    """B strided windows, rows start, start+step, ... of src (T, ...), as
    float32 (B, seq_len, ...); uint8 sources scaled by 1/255."""
    starts = np.asarray(starts, np.int64)
    out = np.empty((len(starts), seq_len) + src.shape[1:], np.float32)
    for b, s in enumerate(starts):
        w = src[s: s + seq_len * step: step]
        out[b] = w.astype(np.float32) / 255.0 if src.dtype == np.uint8 else w
    return out


def normalize_positions(pos: np.ndarray, stat_min: float, stat_max: float):
    """The reference's per-window position normalization, batched: (B, T, 2)
    raw positions -> (normalized, (B, 2) first-frame translations in
    [-1, 1] space)."""
    pos = np.array(pos, np.float32, copy=True, order="C")
    rng = (stat_max - stat_min) or 1.0
    sn = (pos - stat_min) / rng * 2.0 - 1.0
    trans = np.ascontiguousarray(sn[:, 0], np.float32)
    return ((sn - trans[:, None, :]) / 2.0).astype(np.float32), trans


class WindowDataset:
    """Sparse strided windows with reference normalization."""

    def __init__(self, source, obs_horizon: int, pred_horizon: int,
                 step_size: int = 1, stats: Optional[dict] = None):
        if isinstance(source, str):
            source = load_zarr(source)
        if isinstance(source, ReplayBuffer):
            data, ends = source.data, source.episode_ends
            self.meta = dict(source.meta)
        else:
            data, ends = source
            self.meta = {}
        self.episode_ends = np.asarray(ends, np.int64)
        self.obs_horizon = obs_horizon
        self.pred_horizon = pred_horizon
        self.sequence_len = obs_horizon + pred_horizon
        self.step_size = step_size

        self.indices = N.create_sample_indices_sparse(
            ends, self.sequence_len, step_size)
        if len(self.indices) == 0:
            raise ValueError("no valid windows — episodes too short")

        raw = {
            "position": np.asarray(data["position"], np.float32),
            "velocity": np.asarray(data["velocity"], np.float32),
            "action": np.asarray(data["action"], np.float32),
        }
        # per-frame raw sim states, when the dataset carries them
        self.car_state = (np.asarray(data["car_state"], np.float32)
                          if "car_state" in data else None)
        img = np.asarray(data["img"])
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0

        self.inference_mode = stats is not None
        self.stats = stats if stats is not None else self._compute_stats(raw)

        self.train_data = {
            "position": raw["position"],
            "velocity": N.normalize_data(raw["velocity"],
                                         self.stats["velocity"]),
            "action": N.normalize_data(raw["action"], self.stats["action"]),
            "image": img.astype(np.float32),
        }

    def _compute_stats(self, raw):
        """Averaged per-window position min/max (the reference quirk) +
        global action/velocity min-max."""
        pos = raw["position"]
        mins, maxs = [], []
        for start, end, _, _ in self.indices:
            w = pos[start:end:self.step_size]
            mins.append(w.min())
            maxs.append(w.max())
        return {
            "position": {"min": np.float32(np.mean(mins)),
                         "max": np.float32(np.mean(maxs))},
            "velocity": N.get_data_stats(raw["velocity"]),
            "action": N.get_data_stats(raw["action"]),
        }

    def __len__(self):
        return len(self.indices)

    def get_window(self, idx: int):
        start, end, _, _ = self.indices[idx]
        sample = {k: v[start:end:self.step_size]
                  for k, v in self.train_data.items()}
        npos, translation = N.normalize_position(
            sample["position"], self.stats["position"])
        sample["position"] = npos.astype(np.float32)
        if self.inference_mode:
            return sample, translation, int(start), int(end)
        return sample

    def batch(self, idxs, return_translations: bool = False,
              image_frames: Optional[int] = None):
        """Stacked batch {image, position, velocity, action}: (B, T, ...).

        image_frames=n keeps the first n image frames of each window only
        (the policy's conditioning reads the first obs_horizon); None keeps
        all. With return_translations=True also returns the (B, 2)
        per-window first-frame translation vectors."""
        idxs = np.asarray(idxs, np.int64)
        starts = self.indices[idxs, 0]
        seq, step = self.sequence_len, self.step_size
        out = {
            "image": native.gather_windows(self.train_data["image"], starts,
                                           image_frames or seq, step),
            "velocity": native.gather_windows(self.train_data["velocity"],
                                              starts, seq, step),
            "action": native.gather_windows(self.train_data["action"],
                                            starts, seq, step),
        }
        pos = native.gather_windows(self.train_data["position"], starts, seq,
                                    step)
        pos, translations = native.normalize_positions(
            pos, float(self.stats["position"]["min"]),
            float(self.stats["position"]["max"]))
        out["position"] = pos
        if return_translations:
            return out, translations
        return out

    def save_stats(self, path: str):
        save_stats(self.stats, path)


class DeviceWindowDataset:
    """The dataset on the card, windows gathered there.

    Images go to the device as uint8 when that is lossless (4x smaller),
    else as float32; the strided window gather, the /255 and the position
    normalization run as torch ops, so the host supplies only batch
    indices. Outputs match `WindowDataset.batch` to 1 ulp (on the card a
    division by a Python scalar becomes a multiply by its reciprocal).

    `batch(idx, image_frames=n)` gathers the first n image frames of each
    window only. The JAX twin gathers all 40, of which the policy's
    conditioning reads the first obs_horizon (`DiffusionPolicy.obs_cond`);
    at B=256 the full float32 image block is 256*40*27,648*4 B ~ 1.1 GB a
    step. What the loss sees does not change.
    """

    def __init__(self, ds: WindowDataset, device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.stats = ds.stats
        self.sequence_len = ds.sequence_len
        self.step_size = ds.step_size
        self.n_windows = len(ds)

        img = ds.train_data["image"]
        scaled = img * np.float32(255.0)
        rounded = np.round(scaled)
        if np.abs(scaled - rounded).max() < 1e-3:
            img_dev = torch.from_numpy(rounded.astype(np.uint8))   # lossless
        else:
            img_dev = torch.from_numpy(img)
        to = lambda a: torch.as_tensor(a).to(dev)
        self._data = {
            "image": img_dev.to(dev),
            "position": to(ds.train_data["position"]),
            "velocity": to(ds.train_data["velocity"]),
            "action": to(ds.train_data["action"]),
            "starts": to(np.asarray(ds.indices[:, 0], np.int64)),
        }
        self._pmin = float(ds.stats["position"]["min"])
        self._pmax = float(ds.stats["position"]["max"])
        self._offs = torch.arange(self.sequence_len, device=dev) \
            * self.step_size

    def __len__(self):
        return self.n_windows

    def batch(self, idxs, image_frames: Optional[int] = None):
        """{image, position, velocity, action} (B, T, ...) float32 on the
        device for window indices `idxs` (host or device)."""
        data = self._data
        idx = torch.as_tensor(idxs).to(self.device, torch.int64)
        rows = data["starts"][idx][:, None] + self._offs[None, :]
        img = data["image"][rows[:, :image_frames or self.sequence_len]]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        rng = self._pmax - self._pmin
        rng = rng if rng != 0 else 1.0
        sn = (data["position"][rows] - self._pmin) / rng * 2 - 1
        return {"image": img, "velocity": data["velocity"][rows],
                "action": data["action"][rows],
                "position": (sn - sn[:, 0:1]) / 2.0}


def load_stats(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)[0]


def save_stats(stats: dict, path: str) -> None:
    """The reference STATS.pkl sidecar: a single-element list."""
    with open(path, "wb") as f:
        pickle.dump([stats], f)


class DataModule:
    """80/20 split + shuffled batch iterators (the reference's data
    module)."""

    def __init__(self, batch_size: int, data_dir: str = "", T_obs: int = 4,
                 T_pred: int = 8, seed: Optional[int] = None,
                 stats: Optional[dict] = None, step_size: int = 5):
        self.batch_size = batch_size
        self.data_dir = data_dir
        self.T_obs, self.T_pred = T_obs, T_pred
        self.seed = seed
        self.stats = stats
        self.step_size = step_size
        self.data_full: Optional[WindowDataset] = None

    def setup(self, name: str = ""):
        path = os.path.join(self.data_dir, name) if name else self.data_dir
        self.data_full = WindowDataset(
            path, self.T_obs, self.T_pred, self.step_size, stats=self.stats)
        self.stats = self.data_full.stats
        n = len(self.data_full)
        n_train = int(n * 0.8)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        self.train_idx = perm[:n_train]
        self.val_idx = perm[n_train:]

    def _iterate(self, idxs, shuffle: bool, rng=None,
                 drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        order = idxs
        if shuffle:
            rng = rng or np.random.default_rng()
            order = rng.permutation(idxs)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if drop_last and len(chunk) < self.batch_size:
                return
            yield self.data_full.batch(chunk)

    def train_batches(self, rng=None, drop_last=True):
        return self._iterate(self.train_idx, True, rng, drop_last)

    def val_batches(self):
        return self._iterate(self.val_idx, False)

    def save_stats(self, path: str):
        self.data_full.save_stats(path)
