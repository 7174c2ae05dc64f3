from . import normalize
from .collect import collect_episodes, generate_dataset
from .dataset import (
    DataModule, DeviceWindowDataset, WindowDataset, load_stats, save_stats,
)
from .replay_buffer import ReplayBuffer, ZarrReplayBuffer, load_zarr, save_zarr

__all__ = [
    "normalize", "ReplayBuffer", "ZarrReplayBuffer", "save_zarr", "load_zarr",
    "collect_episodes", "generate_dataset", "WindowDataset",
    "DeviceWindowDataset", "DataModule", "load_stats", "save_stats",
]
