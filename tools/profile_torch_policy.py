"""Where the time goes on the GPU, for the PyTorch/CUDA port.

    python3 tools/profile_torch_policy.py [--what denoise|env_step|loop|
                                                 train_step|collect|eval]
                                          [--amp] [--conv-path PATH]
                                          [--conv-bwd pallas] [--repeats R]

--what picks the work that is profiled, after a warm-up:
  denoise   one DDIM-10 denoise of artifacts/r5blend_best (10 U-Net
            forwards at 256 envs), the default;
  env_step  one env_render step of 1024 envs on the 16-track bank (physics,
            tiles, both frames through K2, auto-reset);
  loop      one policy period of the closed loop: 5 frames of r5blend
            driving 256 envs on the 4-track bank, one denoise among them;
  train_step one optimizer step of r5blend at B=256 (loss, backward, the
            clip, Adam, the EMA) on a random batch of 10 frames a window,
            from r5blend's weights;
  collect   data.collect_episodes of the PID lane follower on the 16-track
            bank, 16 envs: a reset and 10 steps, one chunk to the host;
  eval      eval.precision of r5blend (fp32, DDIM-10 leading) at window 70
            of a store the lane follower collected first (16 envs x 210
            steps): 5 samples and their 150-frame replay (render off)
            from the O(1) warm start, as five of the seven evals run.
--conv-path sets `cuda_ops.CONV_PATH` (xla9, xla or pallas; by default
what SPDM_CONV_PATH / SPDM_PALLAS_CONV selected at import): `pallas` runs
the U-Net's conv blocks through the K3-K5 kernels. --conv-bwd sets
`cuda_ops.CONV_BWD` (SPDM_CONV_BWD): `pallas` computes the conv weight
gradients with K6.
It prints the wall time (host clock around work that ends in a
synchronize, unprofiled and profiled; --repeats R takes the unprofiled
one R times and prints their median and each), the device's busy time (the union of
the spans of its events, kernels, copies and sets: kernels chained by
programmatic dependent launch overlap) beside the same events' summed
times (this tool's busy time in its earlier versions), the device's idle
share of the wall time (of the union), the device time by kernel category
(shares of the summed times) and the kernels that take most of it. A launch count is of device
kernels: one K3 wrapper call launches 2-3 (repack, conv, split-K sum).
TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

N_ENVS, TOP = 256, 25

# kernel-name substrings -> category, first match wins
CATEGORIES = [
    ("K1 attention_core", ("attention_core_kernel",)),
    ("K2 sample_banked", ("sample_banked_kernel",)),
    ("K3 conv3x3", ("conv3x3_",)),
    ("K4 gn_act", ("gn_act_kernel",)),
    ("K6 conv_dw", ("conv_dw_",)),
    ("conv / gemm", ("conv", "cudnn", "gemm", "xmma", "cutlass", "sm90_",
                     "wgrad", "dgrad", "fprop", "implicit")),
    ("reduction", ("reduce",)),
    ("gather / index", ("index", "gather")),
    ("copy / cat / layout", ("copy", "cat", "transpose", "permute",
                             "nchw", "nhwc")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def make_work(what: str, amp: bool, dev):
    """(description, work) for --what."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.diffusion.policy import cast_params
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    tag = "amp (bf16)" if amp else "fp32"
    if what in ("collect", "eval"):
        from state_policy_diffusionmodel_torch import eval as E
        from state_policy_diffusionmodel_torch.data import (
            ReplayBuffer, WindowDataset, collect_episodes,
        )

        U = 16
        bank = load_or_build_bank(U, bake=True, device=dev)
        seeds = list(range(100, 100 + U))
        if what == "collect":
            return (f"collection: lane follower, {U} envs x 10 steps and "
                    "the reset", lambda: collect_episodes(
                        seeds, n_steps=10, geoms=bank, device=dev))
        buf = ReplayBuffer()
        for ep in collect_episodes(seeds, n_steps=210, geoms=bank,
                                   return_states=True, device=dev):
            buf.add_episode(ep)
        buf.meta["track_seed"] = np.asarray(seeds, np.int64)
        policy, params, stats = load_run(os.path.join(
            REPO, "artifacts", "r5blend_best"), dev, ema=True)
        cfg = policy.config
        ctx = E.EvalContext(policy=policy, params=params,
                            dataset=WindowDataset(
                                buf, cfg.obs_horizon, cfg.pred_horizon,
                                cfg.step_size, stats=stats),
                            num_inference_steps=10)
        return ("eval.precision, window 70, 5 runs, r5blend EMA fp32",
                lambda: E.precision(ctx, 70, 5))
    if what == "env_step":
        B, U = 1024, 16
        bank = load_or_build_bank(U, bake=True, device=dev)
        ids = torch.arange(B, dtype=torch.int32, device=dev) % U
        box = [vector.init_batch(bank, ids, device=dev)]
        act = torch.tensor([0.05, 0.6, 0.0]).to(dev).expand(B, 3)

        def env_step():
            st, res = vector.step_batch(box[0], bank, act, track_ids=ids,
                                        device=dev)
            box[0] = vector.env.auto_reset(st, bank, ids)
            return res

        return f"one env_render step, {B} envs, {U}-track bank", env_step

    policy, params, stats = load_run(os.path.join(REPO, "artifacts",
                                                  "r5blend_best"), dev)
    if what == "train_step":
        import copy

        from state_policy_diffusionmodel_torch.train import loop as train

        cfg = train.TrainConfig(lr=4e-4, batch_size=N_ENVS, ema_decay=0.9995)
        opt = train.make_optimizer(cfg, params)
        step = train.make_train_step(policy, params, opt, amp,
                                     copy.deepcopy(params), cfg.ema_decay)
        gen = torch.Generator(device=dev).manual_seed(0)
        r = lambda *s: torch.randn(s, generator=gen, device=dev)
        batch = {"position": 0.1 * r(N_ENVS, 40, 2),
                 "velocity": 0.3 * r(N_ENVS, 40, 2),
                 "action": 0.5 * r(N_ENVS, 40, 3),
                 "image": torch.rand((N_ENVS, 10, 96, 96, 3), generator=gen,
                                     device=dev)}

        def train_step():
            return step(batch, cfg.lr, gen)

        return (f"one train step (EMA on), B={N_ENVS}, r5blend, {tag}",
                train_step)
    if what == "loop":
        U = 4
        bank = load_or_build_bank(U, bake=True, device=dev)
        ids = torch.arange(N_ENVS, dtype=torch.int32, device=dev) % U
        fn = diffusion.make_ring_policy(policy, stats, amp=amp)
        pol = diffusion.env_policy(fn, params)
        st, res = vector.reset_batch(bank, track_ids=ids, device=dev)
        box = [st, res, diffusion.init_ring_carry(policy, N_ENVS)]

        def period():
            st, res, carry = box
            for _ in range(policy.config.step_size):
                a, carry = pol(carry, st, res)
                st, res = vector.step_batch(st, bank, a, track_ids=ids,
                                            device=dev)
            box[:] = [st, res, carry]
            return a

        return (f"one closed-loop period ({policy.config.step_size} frames, "
                f"one DDIM-10 denoise), {N_ENVS} envs, {tag}", period)

    if amp:
        params = cast_params(params, torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    window = {k: torch.randn((N_ENVS, 10, d), generator=gen).to(dev)
              for k, d in (("position", 2), ("velocity", 2), ("action", 3),
                           ("image_features", 128))}
    x_T = policy.init_noise(N_ENVS, gen)

    def denoise():
        return policy.sample(params, window, sampler="ddim",
                             num_inference_steps=10, amp=amp,
                             init_noise=x_T)

    return f"DDIM-10 denoise, {N_ENVS} envs, {tag}", denoise


def merged_ms(spans) -> float:
    """Milliseconds covered by at least one of the (start, end) spans, in
    microseconds."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(spans):
        if hi is None or start > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (total + (hi - lo if hi is not None else 0.0)) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="denoise",
                    choices=["denoise", "env_step", "loop", "train_step",
                             "collect", "eval"])
    ap.add_argument("--amp", action="store_true",
                    help="bf16 nets, f32 scheduler math")
    ap.add_argument("--conv-path", choices=["xla9", "xla", "pallas"],
                    default=None, help="the U-Net's conv path "
                    "(cuda_ops.CONV_PATH); pallas = the K3-K5 kernels")
    ap.add_argument("--conv-bwd", choices=["", "pallas"], default=None,
                    help="the training backward's selector "
                    "(cuda_ops.CONV_BWD); pallas = the K6 weight gradient")
    ap.add_argument("--repeats", type=int, default=1,
                    help="unprofiled wall readings; their median is kept")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_policy: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch.profiler import ProfilerActivity, profile

    from state_policy_diffusionmodel_torch.models import cuda_ops

    if args.conv_path is not None:
        cuda_ops.CONV_PATH = args.conv_path
    if args.conv_bwd is not None:
        cuda_ops.CONV_BWD = args.conv_bwd
    dev = torch.device("cuda", 0)
    what, work = make_work(args.what, args.amp, dev)
    what += (f", conv path {cuda_ops.CONV_PATH}, conv backward "
             f"{cuda_ops.CONV_BWD or 'plain'}")

    for _ in range(3):
        work()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_plain_ms = float(np.median(walls))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and device_us(e) > 0]
    kernel_ms = sum(device_us(e) for e in kernels) / 1e3
    # kernels chained by programmatic dependent launch (K3's) overlap, so
    # the device's busy time is the union of the same events' spans
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and e.time_range.end > e.time_range.start]
    busy_ms = merged_ms(spans) if spans else kernel_ms
    launches = sum(e.count for e in kernels)
    print(f"card: {torch.cuda.get_device_name(0)}")
    if args.repeats > 1:
        print(f"unprofiled walls, ms: {[round(w, 3) for w in walls]}")
    print(f"{what}: wall {wall_plain_ms:.3f}"
          f" ms unprofiled, {wall_ms:.3f} ms profiled; device busy "
          f"{busy_ms:.3f} ms (kernel times sum to {kernel_ms:.3f} ms) over "
          f"{launches} kernel launches; idle share "
          f"{1 - busy_ms / wall_plain_ms:.3f} of the unprofiled wall "
          f"({1 - busy_ms / wall_ms:.3f} of the profiled)")
    if not kernels:
        print("profiler recorded no device time", file=sys.stderr)
        return 1
    by_cat = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        c = by_cat[category(e.key)]
        c[0] += device_us(e) / 1e3
        c[1] += e.count
    print("device time by category:")
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat:22s} {ms:9.3f} ms  {100 * ms / kernel_ms:5.1f}%  "
              f"{n:6d} launches")
    print(f"top {TOP} kernels:")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:TOP]:
        print(f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  "
              f"[{category(e.key)}] {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
