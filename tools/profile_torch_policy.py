"""Where the time goes on the GPU, for the PyTorch/CUDA port.

    python3 tools/profile_torch_policy.py [--what denoise|env_step|loop]
                                          [--amp] [--conv-path PATH]

--what picks the work that is profiled, after a warm-up:
  denoise   one DDIM-10 denoise of artifacts/r5blend_best (10 U-Net
            forwards at 256 envs), the default;
  env_step  one env_render step of 1024 envs on the 16-track bank (physics,
            tiles, both frames through K2, auto-reset);
  loop      one policy period of the closed loop: 5 frames of r5blend
            driving 256 envs on the 4-track bank, one denoise among them.
--conv-path sets `cuda_ops.CONV_PATH` (xla9, xla or pallas; by default
what SPDM_CONV_PATH / SPDM_PALLAS_CONV selected at import): `pallas` runs
the U-Net's conv blocks through the K3-K5 kernels.
It prints the wall time (host clock around work that ends in a
synchronize, unprofiled and profiled), the device time summed over the
kernels, the device's idle share of the wall time, the device time by
kernel category and the kernels that take most of it. TF32 is off, as in
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

N_ENVS, TOP = 256, 25

# kernel-name substrings -> category, first match wins
CATEGORIES = [
    ("K1 attention_core", ("attention_core_kernel",)),
    ("K2 sample_banked", ("sample_banked_kernel",)),
    ("K3 conv3x3", ("conv3x3_kernel", "conv3x3_mma_kernel")),
    ("K4 gn_act", ("gn_act_kernel",)),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="denoise",
                    choices=["denoise", "env_step", "loop"])
    ap.add_argument("--amp", action="store_true",
                    help="bf16 nets, f32 scheduler math")
    ap.add_argument("--conv-path", choices=["xla9", "xla", "pallas"],
                    default=None, help="the U-Net's conv path "
                    "(cuda_ops.CONV_PATH); pallas = the K3-K5 kernels")
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
    dev = torch.device("cuda", 0)
    what, work = make_work(args.what, args.amp, dev)
    what += f", conv path {cuda_ops.CONV_PATH}"

    for _ in range(3):
        work()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work()
    torch.cuda.synchronize()
    wall_plain_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{what}: wall {wall_plain_ms:.3f}"
          f" ms unprofiled, {wall_ms:.3f} ms profiled; device busy "
          f"{busy_ms:.3f} ms over {launches} kernel launches; idle share "
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
        print(f"  {cat:22s} {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  "
              f"{n:6d} launches")
    print(f"top {TOP} kernels:")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:TOP]:
        print(f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  "
              f"[{category(e.key)}] {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
