"""Dataset generation CLI, PyTorch.

    python -m state_policy_diffusionmodel_torch.cli.generate_data \
        --modes left right --num_episodes_per_mode 2
    python -m state_policy_diffusionmodel_torch.cli.generate_data \
        --driver sinusoidal --amplitude 5
    python -m state_policy_diffusionmodel_torch.cli.generate_data \
        --driver center_follow --steps 1000 --device cpu

Counterpart of the JAX package's `cli/generate_data.py`, with its flags
and output layout (`<base_dir>/<date>/<name>_dataset_<E>_episodes_<M>
_modes.zarr`, `meta/track_seed`, `data/car_state` unless
`--no_car_states`, `states_list.pkl` beside it with `--save_states`),
plus `--device` (default cuda; cpu runs the plain PyTorch path). All
episodes of a mode collect as one batch of envs. The store is written
as the JAX package writes it: blosc zstd-5 with bitshuffle.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate Data")
    p.add_argument("--num_episodes_per_mode", type=int, default=1)
    p.add_argument("--chunk_len", type=int, default=-1)
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--base_dir", type=str, default="./data/")
    p.add_argument("--modes", nargs="+", default=["left", "right"])
    p.add_argument("--velocities", nargs="+", type=float, default=[30.0])
    p.add_argument("--driver", default="lane_follow",
                   choices=["lane_follow", "sinusoidal", "center_follow"])
    p.add_argument("--amplitude", type=float, default=5.0,
                   help="sinusoidal amplitude: 5=safe, 13=unsafe")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed0", type=int, default=43)
    p.add_argument("--zip", action="store_true", dest="make_zip")
    p.add_argument("--save_states", action="store_true",
                   help="ALSO pickle per-step raw sim states next to the "
                        "dataset (states_list.pkl, the reference sidecar, "
                        "generateParallelTraj.py:77-80); the zarr itself "
                        "always carries data/car_state unless "
                        "--no_car_states")
    p.add_argument("--no_car_states", action="store_true",
                   help="omit the per-frame data/car_state key (O(1) "
                        "mid-episode restore support) from the zarr")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Collect, save and return the store's path."""
    args = parse_args(argv)
    from .. import resolve_device
    from ..data.collect import generate_dataset

    device = resolve_device(args.device)
    folder = datetime.now().strftime("%Y-%m-%d-%H%M")
    name = args.dataset_name or folder
    name = name.removesuffix(".zarr")
    modes = args.modes if args.driver == "lane_follow" else ["n/a"]
    name += (f"_dataset_{args.num_episodes_per_mode}_episodes_"
             f"{len(modes)}_modes.zarr")
    out = os.path.join(args.base_dir, folder, name)
    os.makedirs(os.path.dirname(out), exist_ok=True)

    print(f"==== modes {modes}: {args.num_episodes_per_mode} episodes each x "
          f"{args.steps} steps (driver={args.driver}) ====")
    buffer = generate_dataset(
        "", episodes_per_mode=args.num_episodes_per_mode, modes=modes,
        driver=args.driver, n_steps=args.steps,
        target_velocity=float(args.velocities[0]), seed0=args.seed0,
        save_states=args.save_states or not args.no_car_states,
        device=device, amplitude=args.amplitude, progress=True)
    if args.save_states:
        import pickle

        # every mode's episodes, in buffer order
        with open(os.path.join(os.path.dirname(out),
                               "states_list.pkl"), "wb") as f:
            pickle.dump([buffer.get_episode(i)["car_state"]
                         for i in range(buffer.n_episodes)], f)
    if args.no_car_states:
        buffer.data.pop("car_state", None)
    buffer.save_to_path(out, chunk_length=args.chunk_len,
                        make_zip=args.make_zip)
    print(f"saved {buffer.n_episodes} episodes / {buffer.n_steps} steps "
          f"to {out}")
    return out


if __name__ == "__main__":
    main()
