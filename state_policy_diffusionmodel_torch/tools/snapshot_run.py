"""Snapshot a training run's latest checkpoint into a small directory.

    python -m state_policy_diffusionmodel_torch.tools.snapshot_run \
        RUN_DIR OUT_DIR [--dtype float16]

Counterpart of the JAX package's `tools/snapshot_run.py`: the latest
params as a compressed flat npz under `OUT_DIR/checkpoints/epoch=K/`
(keystr keys, as both packages write them), plus the hparams.yaml and
STATS.pkl sidecars, so OUT_DIR works as a `--run_dir` in both packages.
Optimizer state is dropped: a snapshot is for inference, not resume
(`make_resume_sidecar` makes one resumable). `--dtype float16` halves the
size; loaders cast back to their modules' dtype.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..train import checkpoints as C


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--dtype", default=None,
                    help="downcast floating params (e.g. float16)")
    args = ap.parse_args(argv)

    src = C.latest_checkpoint(args.run_dir)
    if src is None:
        raise SystemExit(f"no checkpoints under {args.run_dir}")
    epoch = os.path.basename(src)
    with np.load(os.path.join(src, "params.npz")) as data:
        leaves = {k: np.asarray(data[k]) for k in data.files}
    if args.dtype:
        leaves = {k: v.astype(args.dtype)
                  if np.issubdtype(v.dtype, np.floating) else v
                  for k, v in leaves.items()}
    dst = os.path.join(args.out_dir, "checkpoints", epoch)
    os.makedirs(dst, exist_ok=True)
    np.savez_compressed(os.path.join(dst, "params.npz"), **leaves)
    for side in ("hparams.yaml", "STATS.pkl"):
        p = os.path.join(args.run_dir, side)
        if os.path.exists(p):
            shutil.copy2(p, os.path.join(args.out_dir, side))
    nbytes = os.path.getsize(os.path.join(dst, "params.npz"))
    print(f"snapshot: {args.out_dir} ({epoch}, params.npz "
          f"{nbytes / 1e6:.1f} MB)")
    return dst


if __name__ == "__main__":
    main()
