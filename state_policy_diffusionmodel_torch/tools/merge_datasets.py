"""Merge two or more episodic zarr datasets into one training zarr.

    python -m state_policy_diffusionmodel_torch.tools.merge_datasets \
        OUT.zarr IN1.zarr IN2.zarr [...]

Counterpart of the JAX package's `tools/merge_datasets.py` (the round-5
blend of a lane-follow and a sinusoidal/PID dataset). Keys are
intersected (sidecars such as h_action or car_state drop out where a
source lacks them); `meta/track_seed` concatenates (-1 for a source
without it), so per-episode replays keep working. The inputs are any
store the port reads (uncompressed, zlib, blosc); the output is zlib.
"""

from __future__ import annotations

import sys

import numpy as np

from ..data.replay_buffer import ReplayBuffer, load_zarr


def merge(out_path: str, srcs) -> ReplayBuffer:
    buffers = [load_zarr(p) for p in srcs]
    keys = set(buffers[0].data)
    for b in buffers[1:]:
        keys &= set(b.data)
    print("common keys:", sorted(keys))
    merged = ReplayBuffer.create_empty_numpy()
    seeds = []
    for p, b in zip(srcs, buffers):
        src_seeds = b.meta.get("track_seed")
        for i in range(b.n_episodes):
            merged.add_episode({k: np.asarray(v)
                                for k, v in b.get_episode(i).items()
                                if k in keys})
            seeds.append(int(src_seeds[i]) if src_seeds is not None else -1)
        print(f"  {p}: +{b.n_episodes} episodes")
    merged.meta["track_seed"] = np.asarray(seeds, np.int64)
    merged.save_to_path(out_path)
    print(f"saved {merged.n_episodes} episodes / {merged.n_steps} steps "
          f"to {out_path}")
    return merged


def main(argv=None):
    argv = [str(a) for a in (sys.argv[1:] if argv is None else argv)]
    if len(argv) < 3:
        raise SystemExit(__doc__)
    return merge(argv[0], argv[1:])


if __name__ == "__main__":
    main()
