"""Benchmark of the PyTorch/CUDA port: env steps/s and closed-loop frames/s.

    python -m state_policy_diffusionmodel_torch.bench --mode env_render
    python -m state_policy_diffusionmodel_torch.bench --mode policy \\
        --run_dir artifacts/r5blend_best --ema --ddim_spacing trailing \\
        --gaussian_init --metrics-frames 1500 --metrics-repeats 5 \\
        --unique-tracks 8 --metrics-only

Modes, metric names and driving metrics follow the JAX package's bench.py
(`bench_env`, `bench_policy`):

- env_only / env_render: B envs on a bank of U tracks (`track_ids =
  arange(B) % U`) step `--steps` times at a fixed action with auto-reset,
  rendering both frames every step in env_render (one K2 launch a step).
  Every step's rewards, and in env_render its frames, go into a checksum
  that is read back after a synchronize, so no step can be skipped.
- policy: the ring policy drives B envs in closed loop for 10 denoises
  (step_size * 10 frames) from a reset, under amp unless --no-amp.
  --metrics-frames N adds the driving metrics: N frames from fresh resets,
  the first obs_horizon * step_size of them at a straight warm-up action,
  repeated --metrics-repeats times with the env -> track assignment rotated
  and a fresh x_T seed; reward and tiles per sim-minute, done fraction.

Each mode prints one JSON line. Times are host wall times of work that ends
in torch.cuda.synchronize(); the best of --repeats runs counts, after one
warm-up run. The bench runs on the GPU; `--device cpu` is for small smoke
runs only.

As in the JAX bench: without --run_dir the policy mode runs random-init
weights (`init_params` from a generator seeded 0; the same FLOPs as a
trained run, no stats, so raw observations), and --epoch picks a
checkpoint of --run_dir; --interp-actions interpolates the queue's rows 0
and 1 between denoises; --profile-dir writes a `utils.profiling.trace`
(a torch.profiler Chrome trace) of one more measured run; --smoke runs
tiny shapes (8 envs, 20 steps, one repeat, a 2-track bank; the policy mode
takes envs // 16, at least 1); and the SPDM_BENCH_DEADLINE watchdog
(seconds; default 95 in env_render, else off) prints the JSON line of the
runs finished so far, marked "partial", when the deadline passes, and
exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from . import resolve_device
from .diffusion import (
    DiffusionPolicy, env_policy, init_ring_carry, make_ring_policy,
)
from .envs import vector
from .track import load_or_build_bank


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# What the deadline watchdog prints: every finished run's time, and how to
# turn a list of them into the bench's JSON line.
_PARTIAL = {"times": [], "fmt": None, "done": False, "printed": False}
_PRINT_LOCK = threading.Lock()


def _register_partial(fmt):
    """fmt(times: list[float]) -> the JSON line's dict."""
    _PARTIAL["fmt"] = fmt
    _PARTIAL["times"] = []


def _emit(out: dict) -> bool:
    """Print the bench's JSON line once, whichever of the main thread and
    the watchdog gets there first."""
    with _PRINT_LOCK:
        if _PARTIAL["printed"]:
            return False
        _PARTIAL["printed"] = True
        print(json.dumps(out), flush=True)
        return True


def _start_watchdog(deadline_s: float, t0: float):
    """When deadline_s seconds have passed since t0, print the line of the
    runs finished so far (marked "partial") as soon as there is one, and
    exit."""
    def watch():
        while not (_PARTIAL["done"] or _PARTIAL["printed"]):
            if time.monotonic() < t0 + deadline_s or not _PARTIAL["times"] \
                    or _PARTIAL["fmt"] is None:
                time.sleep(0.25)
                continue
            out = _PARTIAL["fmt"](list(_PARTIAL["times"]))
            out["partial"] = f"deadline {deadline_s:.0f}s"
            if _emit(out):
                os._exit(0)
            return

    threading.Thread(target=watch, daemon=True).start()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_env(n_envs: int, n_steps: int, repeats: int, render: bool,
              n_unique: int, device="cuda", profile_dir=None):
    """Best env steps/s over `repeats` timed runs of n_steps (and one more
    run under `profiling.trace(profile_dir)` when given)."""
    dev = resolve_device(device)
    bank = load_or_build_bank(n_unique, bake=render, device=dev)
    ids = torch.arange(n_envs, dtype=torch.int32, device=dev) % n_unique
    states = vector.init_batch(bank, ids, device=dev)
    actions = torch.tensor([0.05, 0.6, 0.0]).to(dev).expand(n_envs, 3)

    def run(states):
        chk = torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(n_steps):
            states, res = vector.step_batch(states, bank, actions,
                                            render=render, track_ids=ids,
                                            device=dev)
            states = vector.env.auto_reset(states, bank, ids)
            chk = chk + res.reward.sum()
            if render:
                chk = chk + res.obs.sum(dtype=torch.float64) * 1e-9
        return states, chk

    mode = "env_render" if render else "env_only"
    _register_partial(lambda times: {
        "metric": f"{mode}_steps_per_sec_per_chip",
        "value": round(n_envs * n_steps / min(times), 1),
        "unit": f"env steps/s at {n_envs} envs"})
    times = []
    for i in range(repeats + 1):          # the first run warms up
        _sync(dev)
        t0 = time.perf_counter()
        states, chk = run(states)
        _sync(dev)
        chk = float(chk)
        dt = time.perf_counter() - t0
        _log(f"[bench] run {i}: {dt:.3f} s, checksum {chk:.6f}")
        _PARTIAL["times"].append(dt)
        if i:
            times.append(dt)
    if profile_dir:
        from .utils import profiling

        with profiling.trace(profile_dir) as prof:
            states, chk = run(states)
            float(chk)
        _log(f"[bench] profiler trace written to {prof.trace_path}")
    return n_envs * n_steps / min(times), times


def load_policy(run_dir, ema: bool, gaussian_init: bool, dev,
                epoch=None):
    """(policy, params, stats): a trained run's (its newest checkpoint, or
    `epoch`'s), or with run_dir None the JAX bench's random-init policy
    (UNet_Film, obs 10 / pred 30, the conv-AE encoder, step 5; params from
    a generator seeded 0; stats None)."""
    from .diffusion import PolicyConfig
    from .train import load_run

    if run_dir is None:
        policy = DiffusionPolicy(PolicyConfig(
            noise_steps=1000, obs_horizon=10, pred_horizon=30,
            inpaint_horizon=1, model="UNet_Film",
            vision_encoder="autoencoder", step_size=5), dev)
        params = policy.init_params(torch.Generator().manual_seed(0))
        stats = None
        _log("[bench] random-init policy (generator seeded 0)")
    else:
        policy, params, stats = load_run(run_dir, dev, ema=ema, epoch=epoch)
        _log(f"[bench] loaded {run_dir}"
             + ("" if epoch is None else f" epoch {epoch}")
             + (" (EMA weights)" if ema else ""))
    if gaussian_init:
        policy = DiffusionPolicy(
            dataclasses.replace(policy.config, uniform_init=False), dev)
    return policy, params, stats


def bench_policy(n_envs: int, repeats: int, amp: bool = True,
                 run_dir=None, metrics_frames: int = 0,
                 ddim_spacing: str = "leading", gaussian_init: bool = False,
                 denoise_microbatches: int = 1, num_inference_steps: int = 10,
                 sampler: str = "ddim", ema: bool = False,
                 metrics_repeats: int = 1, n_unique: int = 4,
                 metrics_only: bool = False, device="cuda", epoch=None,
                 interp_actions: bool = False, profile_dir=None):
    """(frames/s or nan, driving dict or None)."""
    dev = resolve_device(device)
    policy, params, stats = load_policy(run_dir, ema, gaussian_init, dev,
                                        epoch)
    cfg = policy.config
    n_unique = min(n_unique, n_envs)
    bank = load_or_build_bank(n_unique, bake=True, device=dev)
    ring = cfg.obs_horizon * cfg.step_size

    def drive(n_frames, ids, seed, warmup):
        fn = make_ring_policy(
            policy, stats, sampler=sampler,
            num_inference_steps=num_inference_steps,
            ddim_spacing=ddim_spacing, amp=amp, seed=seed, warmup=warmup,
            denoise_microbatches=denoise_microbatches,
            interp_actions=interp_actions)
        states, _, out = vector.rollout_policy(
            bank, env_policy(fn, params), init_ring_carry(policy, n_envs),
            n_frames, auto_reset=False, track_ids=ids, device=dev)
        return states, out

    fps = float("nan")
    if not metrics_only:
        n_frames = cfg.step_size * 10
        ids = torch.arange(n_envs, dtype=torch.int32, device=dev) % n_unique
        _register_partial(lambda times: {
            "metric": "closed_loop_policy_frames_per_sec",
            "value": round(n_envs * n_frames / min(times), 1),
            "unit": f"env frames/s at {n_envs} envs"})
        times = []
        for i in range(repeats + 1):      # the first run warms up
            _sync(dev)
            t0 = time.perf_counter()
            states, out = drive(n_frames, ids, 0, 0)
            chk = float(out.reward_alive.sum() + out.actions.sum())
            dt = time.perf_counter() - t0
            _log(f"[bench] policy run {i}: {dt:.3f} s, checksum {chk:.4f}")
            _PARTIAL["times"].append(dt)
            if i:
                times.append(dt)
        fps = n_envs * n_frames / min(times)
        if profile_dir:
            from .utils import profiling

            with profiling.trace(profile_dir) as prof:
                _, out = drive(n_frames, ids, 0, 0)
                float(out.actions.sum())
            _log(f"[bench] profiler trace written to {prof.trace_path}")

    driving = None
    if metrics_frames > 0:
        sim_minutes = metrics_frames / (50.0 * 60.0)
        per = {k: [] for k in ("tiles", "reward", "done", "speed", "onroad")}
        t0 = time.perf_counter()
        for r in range(metrics_repeats):
            ids = (torch.arange(n_envs, dtype=torch.int32, device=dev)
                   + r) % n_unique
            states, out = drive(metrics_frames, ids, 1 + r, ring)
            per["reward"].append(float(out.reward_alive.mean())
                                 / sim_minutes)
            per["tiles"].append(float(states.tile_count.float().mean())
                                / sim_minutes)
            per["done"].append(float(states.done.float().mean()))
            per["speed"].append(float(states.car.vel.norm(dim=-1).mean()))
            per["onroad"].append(float(
                states.wheel_on_road.all(-1).float().mean()))
            _log(f"[bench] metrics repeat {r}: tiles/sim-min "
                 f"{per['tiles'][-1]:.2f}")
        driving = {
            "sim_minutes": round(sim_minutes, 3),
            "reward_per_sim_minute": round(float(np.mean(per["reward"])), 2),
            "tiles_per_sim_minute": round(float(np.mean(per["tiles"])), 2),
            "done_fraction": round(float(np.mean(per["done"])), 3),
            "final_speed_mean": round(float(np.mean(per["speed"])), 2),
            "final_all_wheels_on_road":
                round(float(np.mean(per["onroad"])), 3),
            "wall_seconds": round(time.perf_counter() - t0, 1),
        }
        if metrics_repeats > 1:
            driving.update({
                "metrics_repeats": metrics_repeats,
                "unique_tracks": n_unique,
                "tiles_per_sim_minute_std":
                    round(float(np.std(per["tiles"])), 2),
                "tiles_per_sim_minute_runs":
                    [round(v, 1) for v in per["tiles"]],
                "reward_per_sim_minute_std":
                    round(float(np.std(per["reward"])), 2),
            })
    return fps, driving


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    """Run the bench and print its JSON line; returns the line's dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="env_render",
                    choices=["env_render", "env_only", "policy"])
    ap.add_argument("--envs", type=int, default=None,
                    help="default: 1024 (env modes), 256 (policy)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--unique-tracks", type=int, default=None,
                    help="track-bank size (default: 16 env modes, 4 policy)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--run_dir", default=None,
                    help="policy mode: a trained run dir (default: "
                         "random-init weights, the same FLOPs)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="policy mode: this epoch's checkpoint of --run_dir "
                         "instead of the newest")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--ddim_spacing", default="leading",
                    choices=["leading", "trailing"])
    ap.add_argument("--num_inference_steps", type=int, default=10)
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "dpmpp"])
    ap.add_argument("--gaussian_init", action="store_true")
    ap.add_argument("--no-amp", action="store_true")
    ap.add_argument("--denoise_microbatches", type=int, default=1)
    ap.add_argument("--metrics-frames", type=int, default=0)
    ap.add_argument("--metrics-repeats", type=int, default=1)
    ap.add_argument("--metrics-only", action="store_true")
    ap.add_argument("--interp-actions", action="store_true",
                    help="policy mode: interpolate linearly between queue "
                         "rows 0 and 1 over the step_size frames between "
                         "denoises instead of holding row 0")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of one more measured "
                         "run into this directory (any mode)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for smoke testing")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    if args.envs is None:
        args.envs = 256 if args.mode == "policy" else 1024
    if args.unique_tracks is None:
        args.unique_tracks = 4 if args.mode == "policy" else 16
    _PARTIAL.update(times=[], fmt=None, done=False, printed=False)
    default_deadline = "95" if args.mode == "env_render" else "0"
    deadline = float(os.environ.get("SPDM_BENCH_DEADLINE", default_deadline))
    if deadline > 0:
        _start_watchdog(deadline, t_start)
    if args.smoke:
        args.envs, args.steps, args.repeats = 8, 20, 1
        args.unique_tracks = 2
    dev = resolve_device(args.device)

    if args.mode == "policy":
        if args.smoke:
            args.envs = max(args.envs // 16, 1)
        fps, driving = bench_policy(
            args.envs, args.repeats, amp=not args.no_amp,
            run_dir=args.run_dir, metrics_frames=args.metrics_frames,
            ddim_spacing=args.ddim_spacing, gaussian_init=args.gaussian_init,
            denoise_microbatches=args.denoise_microbatches,
            num_inference_steps=args.num_inference_steps,
            sampler=args.sampler, ema=args.ema,
            metrics_repeats=args.metrics_repeats,
            n_unique=args.unique_tracks,
            metrics_only=args.metrics_only, device=dev, epoch=args.epoch,
            interp_actions=args.interp_actions,
            profile_dir=args.profile_dir)
        out = {
            "metric": "closed_loop_policy_frames_per_sec",
            "value": None if np.isnan(fps) else round(fps, 1),
            "unit": f"env frames/s at {args.envs} envs "
                    f"({args.sampler.upper()}-{args.num_inference_steps} "
                    f"policy in loop, {'fp32' if args.no_amp else 'amp'})",
            "vs_realtime": None if np.isnan(fps)
            else round(fps / (50.0 * args.envs), 3),
        }
        if driving is not None:
            out["driving"] = driving
    else:
        render = args.mode == "env_render"
        value, times = bench_env(args.envs, args.steps, args.repeats, render,
                                 args.unique_tracks, device=dev,
                                 profile_dir=args.profile_dir)
        out = {
            "metric": f"{args.mode}_steps_per_sec_per_chip",
            "value": round(value, 1),
            "unit": f"env steps/s at {args.envs} envs"
                    + (" incl 96x96 render" if render else ""),
            "seconds": [round(t, 4) for t in times],
        }
    out["device"] = device_name(dev)
    _emit(out)
    _PARTIAL["done"] = True
    return out


if __name__ == "__main__":
    main()
