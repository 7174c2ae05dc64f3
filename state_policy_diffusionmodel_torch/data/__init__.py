from . import normalize
from .dataset import (
    DataModule, DeviceWindowDataset, WindowDataset, load_stats, save_stats,
)
from .replay_buffer import ReplayBuffer, load_zarr, save_zarr

__all__ = [
    "normalize", "ReplayBuffer", "save_zarr", "load_zarr", "WindowDataset",
    "DeviceWindowDataset", "DataModule", "load_stats", "save_stats",
]
