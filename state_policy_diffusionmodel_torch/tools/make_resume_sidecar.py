"""Rebuild a trainer_state resume sidecar for a params-only snapshot.

    python -m state_policy_diffusionmodel_torch.tools.make_resume_sidecar \
        RUN_DIR [--lr LR] [--best_val V] [--force] [--initial_lr_ok]

Counterpart of the JAX package's `tools/make_resume_sidecar.py`: from the
latest `checkpoints/epoch=K/params.npz` of RUN_DIR (a snapshot_run
output) it writes `trainer_state/` with FRESH Adam moments (zeros of each
parameter's shape, counts 0), the hyperparameters of the run's
hparams.yaml, and meta epoch K, so `--resume` of either package's trainer
continues from epoch K+1. The model is not built: the optimizer leaves
come from the npz's keystr keys. Plateau runs need `--lr` (the last known
lr) or `--initial_lr_ok`; cosine runs recompute the lr from the epoch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train import checkpoints as C
from ..train.loop import _ADAM, B1, B2, EPS, EPS_ROOT, TrainConfig

_TRAIN_KEYS = ("epochs", "batch_size", "lr", "grad_clip", "min_lr",
               "val_interval", "lr_schedule", "amp", "seed", "device_data",
               "early_stop")


def fresh_adam_leaves(params: dict, lr: float) -> dict:
    """optax's `chain(clip_by_global_norm, inject_hyperparams(adam))` state
    at its init, as keystr leaves: zero moments (float32, each param's
    shape), counts 0, the hyperparameters."""
    out = {}
    for kind in ("mu", "nu"):
        for k, v in params.items():
            out[f"{_ADAM}{kind}{k}"] = np.zeros(v.shape, np.float32)
    zero = np.asarray(0, np.int32)
    out["[1].count"] = zero
    out[f"{_ADAM}count"] = zero
    for k, v in (("b1", B1), ("b2", B2), ("eps", EPS), ("eps_root", EPS_ROOT),
                 ("learning_rate", lr)):
        out[f"[1].hyperparams['{k}']"] = np.asarray(v, np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", help="run dir containing checkpoints/epoch=K "
                                    "(npz snapshot) + hparams.yaml")
    ap.add_argument("--lr", type=float, default=None,
                    help="lr to resume at (plateau runs; cosine ignores it)")
    ap.add_argument("--best_val", type=float, default=None)
    ap.add_argument("--force", action="store_true",
                    help="overwrite an existing trainer_state sidecar (it may "
                         "hold REAL optimizer moments from the original run)")
    ap.add_argument("--initial_lr_ok", action="store_true",
                    help="plateau runs: explicitly accept resuming at the "
                         "undecayed initial lr when --lr is omitted")
    args = ap.parse_args(argv)

    hp = C.load_hparams(os.path.join(args.run_dir, "hparams.yaml"))
    tcfg = TrainConfig(**{k: hp[f"train_{k}"] for k in _TRAIN_KEYS
                          if f"train_{k}" in hp})
    if tcfg.lr_schedule != "cosine" and args.lr is None \
            and not args.initial_lr_ok:
        raise SystemExit(
            f"run uses lr_schedule={tcfg.lr_schedule!r}: resuming without "
            f"--lr would restart at the undecayed initial lr ({tcfg.lr}) "
            "with reset plateau/early-stop state. Pass --lr <last known lr> "
            "(see the run's metrics.jsonl) or --initial_lr_ok to accept the "
            "initial lr.")
    existing = os.path.join(args.run_dir, "trainer_state", "meta.yaml")
    if os.path.exists(existing) and not args.force:
        raise SystemExit(
            f"{existing} already exists: it may hold real optimizer moments "
            "from the original run. Pass --force to overwrite with fresh "
            "moments.")
    latest = C.latest_checkpoint(args.run_dir)
    if latest is None:
        raise SystemExit(f"no checkpoints under {args.run_dir}")
    npz = os.path.join(latest, "params.npz")
    if not os.path.exists(npz):
        raise SystemExit(f"{latest} holds no params.npz")
    epoch = int(os.path.basename(latest).split("=")[1])
    with np.load(npz) as data:
        params = {k: data[k] for k in data.files}

    meta = {"epoch": epoch,
            "lr": float(args.lr if args.lr is not None else tcfg.lr),
            "best_val": float(args.best_val if args.best_val is not None
                              else float("inf")),
            "num_bad": 0, "es_wait": 0}
    path = C.save_train_state(args.run_dir, fresh_adam_leaves(params, tcfg.lr),
                              meta)
    print(f"wrote {path} (resume from epoch {epoch + 1}, "
          f"schedule={tcfg.lr_schedule})")
    return path


if __name__ == "__main__":
    main()
