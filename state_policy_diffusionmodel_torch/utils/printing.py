"""Console banners (parity with the reference's utils/print_utils.py).

A copy of `state_policy_diffusionmodel_tpu/utils/printing.py`.
"""

from __future__ import annotations

import dataclasses


def print_hyperparameters(*configs) -> None:
    print("=" * 18 + " Hyperparameters " + "=" * 18)
    for cfg in configs:
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.asdict(cfg)
        for k, v in cfg.items():
            print(f"  {k:<24} {v}")
    print("=" * 53)


def print_dataset_info(name: str, n_windows: int, n_train: int, n_val: int,
                       obs_horizon: int, pred_horizon: int, step_size: int,
                       fps: int = 50) -> None:
    print("=" * 20 + " Dataset info " + "=" * 19)
    print(f"  dataset                  {name}")
    print(f"  windows                  {n_windows} (train {n_train} / val {n_val})")
    print(f"  observation horizon      {obs_horizon} steps "
          f"({obs_horizon * step_size / fps:.2f} s)")
    print(f"  prediction horizon       {pred_horizon} steps "
          f"({pred_horizon * step_size / fps:.2f} s)")
    print(f"  step size                {step_size} ({step_size / fps:.2f} s)")
    print("=" * 53)
