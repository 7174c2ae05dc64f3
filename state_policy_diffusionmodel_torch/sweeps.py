"""In-process sweeps over checkpoint rows: closed-loop driving metrics
(`drive`) and open-loop accuracy on the shared eval set (`eval`).

    python -m state_policy_diffusionmodel_torch.sweeps drive [--out DIR]
    python -m state_policy_diffusionmodel_torch.sweeps eval [--out DIR]
    python -m state_policy_diffusionmodel_torch.sweeps eval \
        --row r5=artifacts/r5blend_best:ema=true,ddim_spacing=trailing

Counterpart of the JAX package's `tools/drive_sweep.py` and
`tools/eval_sweep.py`, in one module and one process. A row is (name, run
dir, options). The default rows are the exported runs in the repository
(`artifacts/*_best`, whose weights are EMA weights), each with leading and
trailing DDIM spacing; `--row NAME=RUN_DIR[:key=value,...]` (repeatable)
or `--rows_file` (a JSON list of [name, run_dir, {options}]) give others,
and `--rows` keeps the named ones only. Options: ema, epoch, ddim_spacing,
num_inference_steps, and for `drive` also interp_actions.

- drive: each row's policy drives `--envs` envs on a `--unique_tracks`
  bank under the JAX tools' protocol (amp unless --no-amp, N(0,1) x_T,
  `--metrics_frames` frames from fresh resets after a straight warm-up,
  `--metrics_repeats` rotations, throughput skipped; `bench.bench_policy`)
  and writes `<out>/drive_<name>.json` = {"metric": "closed_loop_driving",
  "row", "driving"};
- eval: each row's policy (N(0,1) x_T, DDIM) scores `--max_windows`
  windows of `--dataset_dir/--dataset_name` (by default the shared eval
  store `data/eval_shared/...`, blosc-zstd, read through the port's own
  zstd decoder) with `eval.position_accuracy`, and writes
  `<out>/acc_<name>.json` = {"accuracy": ...}.

A row whose file exists is skipped (a partial drive file is measured
again), as the JAX tools do.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_DIR = os.path.join(REPO, "data", "eval_shared")
SHARED_ZARR = "shared_eval_dataset_6_episodes_3_drivers.zarr"


def default_rows(kind: str) -> list:
    """(name, run_dir, options) for every artifacts/*_best run, EMA weights,
    DDIM leading and trailing."""
    rows = []
    for run in sorted(glob.glob(os.path.join(REPO, "artifacts", "*_best"))):
        if not os.path.exists(os.path.join(run, "hparams.yaml")):
            continue
        name = os.path.basename(run)[:-len("_best")]
        lead = f"{name}_ema_ddim10" if kind == "drive" else f"{name}_ema"
        rows.append((lead, run, {"ema": True}))
        rows.append((f"{name}_ema_trailing", run,
                     {"ema": True, "ddim_spacing": "trailing"}))
    return rows


def _value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def parse_row(spec: str) -> tuple:
    """NAME=RUN_DIR[:key=value,...] -> (name, run_dir, options); values are
    JSON where they parse (true, 3) and strings otherwise."""
    name, _, rest = spec.partition("=")
    run_dir, _, opts = rest.partition(":")
    if not name or not run_dir:
        raise ValueError(f"a row is NAME=RUN_DIR[:key=value,...], got "
                         f"{spec!r}")
    kw = {}
    for item in filter(None, opts.split(",")):
        key, _, val = item.partition("=")
        kw[key] = _value(val)
    return name, run_dir, kw


def drive_row(run_dir: str, device="cuda", envs: int = 256,
              metrics_frames: int = 1500, metrics_repeats: int = 5,
              unique_tracks: int = 8, amp: bool = True, **kw) -> dict:
    """The driving metrics of one row (bench_policy, metrics only)."""
    from . import bench

    _, driving = bench.bench_policy(
        n_envs=envs, repeats=1, amp=amp, run_dir=run_dir, gaussian_init=True,
        metrics_frames=metrics_frames, metrics_repeats=metrics_repeats,
        n_unique=unique_tracks, metrics_only=True, device=device, **kw)
    return driving


def eval_row(run_dir: str, device="cuda", ema: bool = False, epoch=None,
             ddim_spacing: str = "leading", num_inference_steps: int = 10,
             max_windows: int = 120, dataset_dir: str = SHARED_DIR,
             dataset_name: str = SHARED_ZARR) -> dict:
    """The position and action accuracy of one row on the dataset (N(0,1)
    x_T, DDIM), as lists and floats."""
    from . import diffusion, eval as E, resolve_device
    from .data.dataset import DataModule
    from .train.checkpoints import load_run

    dev = resolve_device(device)
    policy, params, stats = load_run(run_dir, dev, ema=ema, epoch=epoch)
    policy = diffusion.DiffusionPolicy(
        dataclasses.replace(policy.config, uniform_init=False), dev)
    cfg = policy.config
    dm = DataModule(batch_size=1, data_dir=dataset_dir,
                    T_obs=cfg.obs_horizon, T_pred=cfg.pred_horizon,
                    stats=stats, step_size=cfg.step_size)
    dm.setup(dataset_name)
    ctx = E.EvalContext(policy=policy, params=params, dataset=dm.data_full,
                        sampler="ddim",
                        num_inference_steps=num_inference_steps,
                        ddim_spacing=ddim_spacing)
    out = E.position_accuracy(ctx, max_windows)
    return {k: (np.asarray(v).tolist()
                if isinstance(v, (np.ndarray, np.generic)) else v)
            for k, v in out.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kind", choices=["drive", "eval"])
    ap.add_argument("--out", default="results/torch_sweep")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names to run (default: all)")
    ap.add_argument("--row", action="append", default=[],
                    help="NAME=RUN_DIR[:key=value,...], repeatable; replaces "
                         "the default rows")
    ap.add_argument("--rows_file", default=None,
                    help="JSON list of [name, run_dir, {options}]")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    # drive
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--metrics_frames", type=int, default=1500)
    ap.add_argument("--metrics_repeats", type=int, default=5)
    ap.add_argument("--unique_tracks", type=int, default=8)
    ap.add_argument("--no-amp", action="store_true")
    # eval
    ap.add_argument("--max_windows", type=int, default=120)
    ap.add_argument("--dataset_dir", default=SHARED_DIR)
    ap.add_argument("--dataset_name", default=SHARED_ZARR)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the rows; returns {name: the row's JSON payload} for the rows
    measured in this call."""
    args = parse_args(argv)
    rows = [parse_row(r) for r in args.row]
    if args.rows_file:
        with open(args.rows_file) as f:
            rows += [tuple(r) for r in json.load(f)]
    rows = rows or default_rows(args.kind)
    only = set(args.rows.split(",")) if args.rows else None
    os.makedirs(args.out, exist_ok=True)
    done = {}
    for name, run_dir, kw in rows:
        if only is not None and name not in only:
            continue
        prefix = "drive" if args.kind == "drive" else "acc"
        path = os.path.join(args.out, f"{prefix}_{name}.json")
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path) as f:
                if '"partial"' not in f.read():
                    print(f"[{args.kind}] {name}: exists, skip", flush=True)
                    continue
        print(f"[{args.kind}] {name} ...", flush=True)
        if args.kind == "drive":
            driving = drive_row(
                run_dir, args.device, args.envs, args.metrics_frames,
                args.metrics_repeats, args.unique_tracks, not args.no_amp,
                **kw)
            payload = {"metric": "closed_loop_driving", "row": name,
                       "driving": driving}
            brief = driving
        else:
            res = eval_row(run_dir, args.device, max_windows=args.max_windows,
                           dataset_dir=args.dataset_dir,
                           dataset_name=args.dataset_name, **kw)
            payload = {"accuracy": res}
            brief = {k: res[k] for k in (
                "overall", "action_overall", "action_mae_gas",
                "action_bias_gas", "action_bias_steer")}
        with open(path, "w") as f:
            json.dump(payload, f)
        print(f"[{args.kind}] {name}: {brief}", flush=True)
        done[name] = payload
    return done


if __name__ == "__main__":
    main()
