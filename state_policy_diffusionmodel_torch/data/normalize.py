"""Normalization and windowing, semantics-identical to the reference.

A copy of `state_policy_diffusionmodel_tpu/data/normalize.py` (numpy only),
kept here so the port imports nothing of the JAX package. It mirrors
the reference implementation's `utils/data_utils.py`:
- min-max to [-1, 1] for actions/velocities (:18-26),
- positions: min-max with *scalar* stats, translate the window to its first
  frame, divide by 2 (:28-40),
- sparse strided window indices (:46-62),
- dense padded window indices used by two eval scripts (:64-127).

The position-stats quirk is reproduced deliberately: the reference's
`stats['position']` min/max are the *averages of per-window min/max* over
the whole dataset (`utils/load_data.py:58-78`), not global extrema.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def get_data_stats(data: np.ndarray) -> Dict[str, np.ndarray]:
    flat = data.reshape(-1, data.shape[-1])
    return {"min": flat.min(0), "max": flat.max(0)}


def normalize_data(data, stats):
    # guard degenerate (constant) dims: the reference divides by zero there
    # (data_utils.py:18-21); we map them to -1 deterministically instead.
    rng = np.asarray(stats["max"]) - np.asarray(stats["min"])
    rng = np.where(rng == 0, 1.0, rng)
    ndata = (data - stats["min"]) / rng
    return ndata * 2 - 1


def unnormalize_data(ndata, stats):
    ndata = (np.asarray(ndata) + 1) / 2
    return ndata * (stats["max"] - stats["min"]) + stats["min"]


def normalize_position(sample, position_stats):
    """Returns (normalized sample, translation vector)."""
    sn = normalize_data(sample, position_stats)
    translation = sn[..., 0, :].copy() if sn.ndim > 2 else sn[0, :].copy()
    if sn.ndim > 2:
        nsample = (sn - translation[..., None, :]) / 2.0
    else:
        nsample = (sn - translation) / 2.0
    return nsample, translation


def unnormalize_position(nsample, translation, position_stats):
    nsample = np.asarray(nsample)
    if np.ndim(translation) and np.asarray(translation).ndim == nsample.ndim - 1:
        s = nsample * 2.0 + np.asarray(translation)[..., None, :]
    else:
        s = nsample * 2.0 + translation
    return unnormalize_data(s, position_stats)


def create_sample_indices_sparse(ends, sequence_length: int, step_size: int):
    """(N, 4) [start, segment_end, 0, sequence_length] windows; every start
    whose strided window fits in the episode (data_utils.py:46-56)."""
    indices = []
    prev_end = 0
    for end in ends:
        for start in range(prev_end, end - sequence_length + 1):
            if start + sequence_length * step_size <= end:
                indices.append([start, start + sequence_length * step_size,
                                0, sequence_length])
        prev_end = int(end)
    return np.asarray(indices, np.int64).reshape(-1, 4)


def sample_sequence_sparse(data: Dict[str, np.ndarray], step_size, start, end):
    return {k: v[start:end:step_size] for k, v in data.items()}


def create_sample_indices(episode_ends, sequence_length: int,
                          pad_before: int = 0, pad_after: int = 0):
    """Dense edge-padded windows (data_utils.py:64-90)."""
    indices = []
    for i in range(len(episode_ends)):
        start_idx = 0 if i == 0 else int(episode_ends[i - 1])
        episode_length = int(episode_ends[i]) - start_idx
        min_start = -pad_before
        max_start = episode_length - sequence_length + pad_after
        for idx in range(min_start, max_start + 1):
            buffer_start = max(idx, 0) + start_idx
            buffer_end = min(idx + sequence_length, episode_length) + start_idx
            start_offset = buffer_start - (idx + start_idx)
            end_offset = (idx + sequence_length + start_idx) - buffer_end
            indices.append([buffer_start, buffer_end,
                            start_offset, sequence_length - end_offset])
    return np.asarray(indices, np.int64).reshape(-1, 4)


def sample_sequence(data: Dict[str, np.ndarray], sequence_length,
                    buffer_start, buffer_end, sample_start, sample_end):
    """Edge-padded window gather (data_utils.py:110-127)."""
    out = {}
    for k, arr in data.items():
        sample = arr[buffer_start:buffer_end]
        if sample_start > 0 or sample_end < sequence_length:
            padded = np.zeros((sequence_length,) + arr.shape[1:], arr.dtype)
            if sample_start > 0:
                padded[:sample_start] = sample[0]
            if sample_end < sequence_length:
                padded[sample_end:] = sample[-1]
            padded[sample_start:sample_end] = sample
            sample = padded
        out[k] = sample
    return out
