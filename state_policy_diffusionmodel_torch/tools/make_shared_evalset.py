"""Build the shared benchmark eval set on the device.

    python -m state_policy_diffusionmodel_torch.tools.make_shared_evalset \
        [--out data/eval_shared] [--force] [--steps 2000] [--device cuda]

Counterpart of the JAX package's `tools/make_shared_evalset.py`, with its
composition (6 episodes x 2,000 steps = 12k frames): 2 lane-follow (left
on seed 900, right on 901), 2 center-follow (910, 911), 2 sinusoidal with
amplitude 5 (920, 921), at target velocity 30, with per-frame car states;
`meta/track_seed` and `meta/driver_id` (0 lane_follow, 1 center_follow,
2 sinusoidal). Collected by the port's `data.collect_episodes`; written
zlib (the port writes zlib only), to
`<out>/shared_eval_dataset_6_episodes_3_drivers.zarr`.

Unlike the JAX tool, it refuses to write over an existing store unless
`--force` is given: `--out` defaults to the JAX tool's directory, whose
committed store is the JAX package's blosc-zstd reference set (the one its
accuracy records were taken on), and the port's frames differ from it by
float32 rounding.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.collect import collect_episodes
from ..data.replay_buffer import ReplayBuffer

SPEC = [
    # (driver, mode, seeds, extra kwargs)
    ("lane_follow", "left", [900], {}),
    ("lane_follow", "right", [901], {}),
    ("center_follow", "n/a", [910, 911], {}),
    ("sinusoidal", "n/a", [920, 921], {"amplitude": 5.0}),
]
N_STEPS = 2000
DRIVER_NAMES = ["lane_follow", "center_follow", "sinusoidal"]
STORE = "shared_eval_dataset_6_episodes_3_drivers.zarr"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/eval_shared")
    ap.add_argument("--force", action="store_true",
                    help="write over an existing store")
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = os.path.join(args.out, STORE)
    if os.path.exists(out) and not args.force:
        raise SystemExit(f"{out} exists (the shared reference set where "
                         "--out is data/eval_shared); pass --force to "
                         "write over it")

    buffer = ReplayBuffer.create_empty_numpy()
    all_seeds, all_drivers = [], []
    for driver, mode, seeds, kw in SPEC:
        print(f"==== {driver} ({mode}) seeds {seeds}: {args.steps} steps ====")
        for ep, seed in zip(
            collect_episodes(seeds, driver=driver, mode=mode,
                             n_steps=args.steps, target_velocity=30.0,
                             return_states=True, progress=True,
                             device=args.device, **kw),
            seeds,
        ):
            ep.pop("h_action", None)   # uniform keys across drivers
            buffer.add_episode(ep)
            all_seeds.append(seed)
            all_drivers.append(driver)
    buffer.meta["track_seed"] = np.asarray(all_seeds, np.int64)
    buffer.meta["driver_id"] = np.asarray(
        [DRIVER_NAMES.index(d) for d in all_drivers], np.int64)
    assert buffer.n_episodes == 6, buffer.n_episodes
    os.makedirs(args.out, exist_ok=True)
    buffer.save_to_path(out)
    print(f"saved {buffer.n_episodes} episodes / {buffer.n_steps} steps "
          f"to {out}")
    return out


if __name__ == "__main__":
    main()
