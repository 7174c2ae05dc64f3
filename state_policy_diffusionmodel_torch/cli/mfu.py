"""Model-FLOPs utilization (MFU) table of the denoiser and the train step,
PyTorch port.

    python -m state_policy_diffusionmodel_torch.cli.mfu      # on the card
    python -m state_policy_diffusionmodel_torch.cli.mfu --conv_path pallas
    python -m state_policy_diffusionmodel_torch.cli.mfu --device cpu \
        --model_width 8 --batches 4 --train_batch 2

Counterpart of the JAX package's `cli/mfu.py`, with its rows and flags
(`--batches`, `--train_batch`, `--amp`, `--model_width`, `--peak`,
`--out`), plus `--conv_path` and `--device`. For each program it reports:

- FLOPs, counted by `torch.utils.flop_counter.FlopCounterMode` over one
  execution on the plain path (attention through its plain version, the
  default conv path). The counter sees the convolutions and matmuls of
  PyTorch's operators only: it cannot see inside the port's ctypes-launched
  kernels, hence the plain path, and it counts no elementwise work. XLA's
  `cost_analysis()`, which the JAX tool reads, also counts elementwise
  operations (GroupNorm, GELU, the optimizer), so its count is higher for
  the same net;
- the device time of one execution: K_INNER executions chained (each
  adds to a running sum the next does not read, as the JAX tool chains
  them in one `lax.scan`) between two CUDA events, the median of
  `repeats` such runs divided by K_INNER, on the path the caller picks:
  the default conv path (cuDNN) or `--conv_path pallas` (K3-K5), K1 in
  both (host wall time on the CPU);
- achieved TFLOP/s and MFU against the card's bf16 dense tensor-core peak.

The peak comes from the card's name (`PEAKS`); `--peak` overrides it, and a
card not in the table raises unless `--peak` is given. On the CPU there is
no peak unless `--peak` is given, and MFU is left out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import numpy as np
import torch

# bf16 dense tensor-core peak by device name. NVIDIA H100 Tensor Core GPU
# datasheet, H100 SXM: "BF16 Tensor Core 1,979 teraFLOPS" with sparsity,
# half of it dense
PEAKS = {"NVIDIA H100 80GB HBM3": 1979e12 / 2}

K_INNER = 10   # executions per timed run


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--peak", default=None,
                    help="bf16 peak FLOP/s (overrides the card's entry)")
    ap.add_argument("--batches", default="256,1024",
                    help="denoiser forward batch sizes")
    ap.add_argument("--train_batch", type=int, default=16)
    ap.add_argument("--amp", action="store_true",
                    help="train step with bf16 compute (TrainConfig.amp)")
    ap.add_argument("--model_width", type=int, default=None,
                    help="U-Net base channels (None = the reference's 64 "
                         "plan)")
    ap.add_argument("--conv_path", default="xla9",
                    choices=["xla9", "pallas"],
                    help="the timed path's U-Net convs: cuDNN (xla9) or the "
                         "conv kernels K3-K5 (pallas)")
    ap.add_argument("--out", default=None, help="write rows as JSON here")
    ap.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return ap.parse_args(argv)


def peak_flops(device: torch.device, override=None):
    """The bf16 dense peak in FLOP/s: `override`, else the card's entry in
    PEAKS; None on the CPU; a card not in PEAKS raises."""
    if override:
        return float(override)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise ValueError(f"no bf16 peak known for {name!r}: pass --peak")
    return PEAKS[name]


@contextlib.contextmanager
def plain_path():
    """Every operator the FLOP counter can see: attention through its plain
    version, the default conv path."""
    from ..models import cuda_ops

    with mock.patch.object(cuda_ops, "attention_core",
                           cuda_ops.attention_core_ref), \
            mock.patch.object(cuda_ops, "CONV_PATH", "xla9"):
        yield


def count_flops(fn) -> int:
    """FLOPs of one fn() on the plain path (FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    with plain_path():
        counter = FlopCounterMode(display=False)
        with counter:
            fn()
    return int(counter.get_total_flops())


def time_chained(fn, device: torch.device, repeats: int = 5) -> float:
    """Median seconds of one fn() over `repeats` runs of K_INNER chained
    calls (CUDA events on the card, host wall time on the CPU)."""
    def run():
        acc = torch.zeros((), device=device)
        for _ in range(K_INNER):
            acc = acc + fn().float().sum()
        return acc

    run()                                           # warm-up
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            float(run())
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) / K_INNER


def denoiser_forward(policy, params, B: int):
    """fn() running the U-Net once in bf16 (the closed loop's amp forward)
    at batch B on zeros, as the JAX tool's row does."""
    from ..diffusion.policy import cast_params

    cfg = policy.config
    dev = policy.device
    unet = cast_params(params, torch.bfloat16)["unet"]
    x = torch.zeros((B, cfg.horizon, cfg.prediction_dim, 1),
                    dtype=torch.bfloat16, device=dev)
    t = torch.zeros((B,), dtype=torch.int64, device=dev)
    cond = torch.zeros((B, cfg.obs_horizon * cfg.observation_dim),
                       dtype=torch.bfloat16, device=dev)

    @torch.no_grad()
    def fn():
        return unet(x, t, cond)

    return fn


def train_step(policy, params, B: int, amp: bool):
    """fn() taking one optimizer step (the loss, its backward, the clip and
    Adam; no EMA) at batch B on zeros, as the JAX tool's row does."""
    from .. import train

    cfg = policy.config
    dev = policy.device
    tcfg = train.TrainConfig(batch_size=B, lr=1e-4, amp=amp)
    step = train.make_train_step(policy, params,
                                 train.make_optimizer(tcfg, params), amp)
    T = cfg.obs_horizon + cfg.pred_horizon
    batch = {"position": torch.zeros((B, T, 2), device=dev),
             "action": torch.zeros((B, T, 3), device=dev),
             "velocity": torch.zeros((B, T, 2), device=dev),
             # the conditioning encodes the first obs_horizon frames only
             "image": torch.zeros((B, cfg.obs_horizon, 96, 96, 3),
                                  device=dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    return lambda: step(batch, 1e-4, gen)


def mfu_rows(device, batches=(256, 1024), train_batch: int = 16,
             amp: bool = False, model_width=None, peak=None,
             conv_path: str = "xla9", repeats: int = 5, log=print) -> dict:
    """{"device", "peak_flops", "conv_path", "rows": [{"program", "gflops",
    "ms", "tflops_per_sec", "mfu_pct"}]}: the denoiser forward in bf16 at
    each of `batches`, then the train step at `train_batch` (fp32, or amp;
    none when 0), at random init (UNet_Film, obs 10 / pred 30, the conv-AE
    encoder)."""
    from .. import diffusion, resolve_device
    from ..models import cuda_ops

    dev = resolve_device(device)
    peak = peak_flops(dev, peak)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}, bf16 peak "
        + (f"{peak / 1e12:.1f} TFLOP/s" if peak else "not known")
        + f", conv path {conv_path}")
    cfg = diffusion.PolicyConfig(model_width=model_width)
    policy = diffusion.DiffusionPolicy(cfg, dev)
    params = policy.init_params(torch.Generator().manual_seed(0))
    wtag = "" if model_width is None else f" w={model_width}"
    rows = []

    def row(program, fn):
        flops = count_flops(fn)
        with mock.patch.object(cuda_ops, "CONV_PATH", conv_path):
            secs = time_chained(fn, dev, repeats)
        tf = flops / secs / 1e12
        rows.append({"program": program, "gflops": flops / 1e9,
                     "ms": secs * 1e3, "tflops_per_sec": tf,
                     "mfu_pct": None if peak is None
                     else 100.0 * flops / secs / peak})
        mfu = rows[-1]["mfu_pct"]
        log(f"{program:38s} {flops / 1e9:10.2f} GF {secs * 1e3:9.3f} ms "
            f"{tf:8.2f} TF/s  MFU "
            + ("-" if mfu is None else f"{mfu:5.2f}%"))

    for B in batches:
        row(f"denoiser fwd bf16 B={B}{wtag}",
            denoiser_forward(policy, params, B))
    if train_batch:
        prec = "amp-bf16" if amp else "fp32"
        row(f"train step {prec} B={train_batch}{wtag} (w/ encoder)",
            train_step(policy, params, train_batch, amp))
    return {"device": name, "peak_flops": peak, "conv_path": conv_path,
            "rows": rows}


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = mfu_rows(args.device, [int(b) for b in args.batches.split(",")],
                   args.train_batch, args.amp, args.model_width, args.peak,
                   args.conv_path)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
