"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--only k1,k2,k4,md]

`--only` runs the device and build phases and then the named phases alone
(K1 with its U-Net forwards, K2 on its four cases, K4; md: the collection
and the multi-device phase, which on a machine of several cards also runs
NCCL with a rank a card), printing their records, the card and the last
line as below.

Phases, each printed with its seconds:
  1. device   the card (nvidia-smi name and power limit), torch, nvcc;
  2. build    nvcc builds every kernel of the port (K1-K4 and K6; K5 is K3
              and K4) into build/, one nvcc per source, all started
              together;
  3. K1       the attention_core CUDA kernel (the ptxas line of each of
              its kernels; the row kernel must not spill) against its plain
              PyTorch version at the five attention shapes of one r5blend
              U-Net forward (B=256, 4 heads) and at the shapes off that path
              (WIDE_ATTN_SHAPES: width 128, T=384, ragged T, Dh=8, heads of
              160 and 256 on the row path) in fp32 and bf16, twice
              (bit-identical), with its time, the plain version's,
              F.scaled_dot_product_attention's
              (timed as a yardstick only) and the least time the card could
              take (the largest of the bytes, the operations and the
              exponentials; the earlier two-term bound beside it); then
              U-Net forwards off r5blend's path (widths 128 and 256, and a
              48x8 input), random init, B=64, fp32 and bf16: 5 K1 launches
              each, K1 held against its plain version on the forward's own
              activations (K1_REL_TOL);
  K3-K5       the conv path's kernels against their plain versions at every
              shape of one r5blend U-Net forward on the conv-kernel path
              (B=256, fp32 and bf16): conv3x3 (K3) at its 17 conv shapes,
              twice (bit-identical), with cuDNN's channels-last F.conv2d
              timed as the yardstick, the achieved TFLOP/s, its plan and
              the ptxas line (registers, shared memory, spills) of each of
              its kernels;
              gn_act (K4) at its 10 shapes in its four variants (GroupNorm,
              +GELU, +affine, +affine+residual), twice (bit-identical), with
              its plan, its time (the median of three readings),
              F.group_norm's for GroupNorm alone (a yardstick) and the
              ptxas lines (no spills); double_conv (K5) at
              the 14 distinct shapes of the 15 DoubleConvs;
  nets        K3-K5 at the 17 conv and 12 DoubleConv shapes of a UNetSimple
              forward (width 16, B=256; SIMPLE_DC_SHAPES, six of them
              residual), fp32 and bf16, twice (bit-identical), timed as
              above (no conv3x3 kernel may spill); then one UNetSimple
              forward from flax's initializers on the conv-kernel path:
              exactly 24 K3, 24 K4 and 12 K5 launches, each DoubleConv held
              against its plain version on its own activations, and
              DDIM-10 on both conv paths within SIMPLE_CHAIN_TOL;
  K6          conv_dw, the conv weight gradient, against its plain version
              at the 17 distinct conv shapes of one r5blend training step
              (B=256, fp32 and bf16), twice (bit-identical), with cuDNN's
              weight gradient (aten.convolution_backward, dw only) timed
              as the yardstick, the achieved TFLOP/s, its plan and the
              ptxas lines; and K1's backward (plain torch, as JAX's) timed
              at the five attention shapes;
  K2, env     the sample_banked CUDA kernel (its ptxas lines, no spills)
              against its plain version at B=1024 and B=256 on the 16-track
              bank, on random poses (edges and off-field included) and on
              the env's poses after 50 steps: every output equal, twice,
              with its plan, its time, the plain version's and the bound;
              the golden car states rendered on
              the card within 30 bytes a frame of golden_frames.npz; 16
              envs x 40 steps on the card against the CPU (rewards, tiles
              and done flags equal, positions within ENV_POS_TOL, frames
              within 30 bytes); env_only and env_render at 1024 envs x 200
              steps (steps/s, one K2 launch per rendered step);
  4. policy   load artifacts/r5blend_best and serve 256 envs x 50 frames
              through the DDIM-10 ring policy (10 denoises), fed the
              golden frames of tests/fixtures; the run must launch K1
              5 x 10 x 10 = 500 times; the same rollout on the plain
              attention path, with K1 held against it on the policy's own
              activations, must give the same actions in fp32, and under
              amp (bf16) both must lie within a stated mean and share of
              the fp32 plain path; a bf16 probe (one ulp on a few of K1's
              outputs) shows how far such a difference moves the actions;
              frames/s and the time of one denoise in fp32 and under amp;
              then the same rollouts on the conv-kernel path
              (cuda_ops.CONV_PATH = "pallas", SPDM_CONV_PATH=pallas): exactly
              500 K1, 3,000 K3, 3,000 K4 and 1,500 K5 launches, fp32 actions
              within ACTION_TOL of the fp32 plain path, amp within the amp
              limits, and K3-K5 held against their plain versions on the
              policy's own activations (ShadowDoubleConv);
  closed loop r5blend drives 256 envs on the 4-track bank through the env,
              K2 and K1 (rollout_policy with the ring policy), 50 frames in
              fp32 and under amp: frames/s, exactly 500 K1 and 51 K2
              launches (50 frames and the reset), none of K3-K5 on the
              default conv path, fp32 actions within ACTION_TOL of the plain
              path's (every kernel plain), and the driving metrics of a
              500-frame amp run; then the same loop on the conv-kernel path:
              launch counts exact, fp32 actions against the all-plain path;
  denoise     one DDIM-10 denoise in fp32 and under amp, on the default and
              the conv-kernel path;
  5. cpu      a small rollout on the card against the same on the CPU;
  r4rn serve  artifacts/r4rn_best (UNetFiLM + a trained ResNet18GN) through
              load_run: the observation-fed policy as r5blend's (500 K1,
              fp32 actions within ACTION_TOL of the plain attention path),
              the closed loop in fp32 and amp on both conv paths (500 K1,
              51 K2; 3,000 K3, 3,000 K4, 1,500 K5 on the kernels), frames/s
              and the ResNet's ms on one 256-frame batch;
  6. collect  the PID lane follower (mode middle, speed 30) on the 16-track
              bank (seeds 100..115), 16 envs x 400 steps through
              data.collect_episodes with car_state: exactly 401 K2 launches
              (a step and the reset) and nothing else, env steps/s; the
              same drive stepped once more through the public env and
              controller API (lane_probe), untimed, its actions equal to
              the collected ones: the share of steps on which the lane was
              found, each episode's tile count rising; 50 steps each of
              the centre follower and
              the sinusoidal weaver, actions finite; the lane follower's
              episodes written through the default ZarrReplayBuffer (the
              JAX store's blosc zstd-5 with bitshuffle, the host library's
              encoder) into a temporary directory and read back through
              load_zarr, equal array for array: the bytes on disk, the
              write's seconds and MB/s (host), and the bytes of the same
              episodes written as zlib level 1 and their load_zarr time
              beside the default store's (warm page cache), beside the
              card's name and power limit;
     codecs   the first CODEC_EPISODES (4) of those episodes, read from
              that store, written through save_to_path with each zarr
              compressor of CODEC_SPECS (gzip 5, bz2 1, zstd 3, blosc
              blosclz-5 and snappy-5 with byte shuffle, blosc lz4-5 with
              auto shuffle and blocksize 65,536) on every array, read back
              through load_zarr, equal array for array, each `.zarray`
              stating the compressor as tensorstore would: the bytes on
              disk, the write's seconds and MB/s and the read's (host),
              beside the card's name and power limit;
  7. training (on that store; the run written in the same directory):
     windows  the port's WindowDataset over it: 16 x 201 = 3,216 windows;
     gradients  one batch of 256 of those windows at fixed t and noise,
              r5blend's weights: the U-Net's gradients on the default path
              (K1), SPDM_CONV_BWD=pallas (K1 + K6), SPDM_CONV_PATH=pallas
              (K1 + K5's forward) and both, each against the all-plain
              path: fp32 within GRAD_TOL of each tensor's largest |grad|,
              amp within AMP_GRAD_FACTOR of the plain amp path's distance
              from fp32; exact launches a step (5 K1; 31 K6; 30 K3, 30 K4,
              15 K5);
     CLI      one epoch of `python -m state_policy_diffusionmodel_torch.cli.
              train_policy` on that store with r5blend's recipe (B=256, Adam
              4e-4 cosine to 1e-6, EMA 0.9995, device data, the frozen
              r5blend encoder) on the default paths in fp32: every loss
              finite and the run dir complete;
     serve    load_run(..., ema=True) of that run drives 16 envs x 10 frames
              in closed loop;
     timing   train steps at B=256 from r5blend's weights with EMA, fp32
              and amp, on the four paths: the median ms of 5 steps after 2
              (host wall time ending in a synchronize), samples/s, launches;
  8. eval     r5blend's EMA weights through cli/evaluate.py's `all` on the
              collected store in fp32 (window 70, 256 accuracy windows,
              DDIM-10 leading): each eval's summary and wall seconds, K1
              launched and no other kernel (the replays do not render),
              accuracy windows/s, every returned value finite; K1 at the
              eval's batch sizes (1, 5, 64) on r5blend's five shapes, fp32,
              within K1_TOL of its plain version and twice bit-identical;
              and the O(1)
              car_state warm start at window 70 within 5e-3 of the replay
              warm start.
  r4rn train  on that store, the encoder trained: the U-Net's and the
              ResNet's gradients on the default path and SPDM_CONV_BWD=pallas
              against the all-plain path (floored_grad_gap; amp within
              AMP_GRAD_FACTOR; 5 K1, 31 K6 a step), train-step ms in fp32
              and amp, one CLI epoch with --vision_encoder resnet18
              --train_encoder, its EMA run served 16 envs x 10 frames;
  autoencoder r3_autoencoder on the golden frames, card against CPU within
              AE_TOL; two epochs of cli/train_autoencoder.py on the
              collected frames (the val loss falling); cli/train_policy.py
              --encoder_ckpt of that run keeps its encoder;
  9. native   the port's host library (the C++ window gather, built with
              g++): WindowDataset.batch of 256 windows of the collected
              store equal to the numpy plain version's, array for array;
              the ms of a batch each way;
  sample      cli/sample.py's computation: r5blend (EMA) on a validation
              window of the collected store, DDPM (all 1,000 steps),
              DDIM-10 leading and trailing and DPM++-10 at one x_T: the
              history (steps+1, 1, 31, 5) finite, its last row the sample
              without history, exactly 5 K1 launches a U-Net forward and no
              other kernel, within ACTION_TOL of the plain attention path;
              seconds each;
  run_predictions  cli/run_predictions.py's computation: r5blend (EMA), one
              env on track 42; 150 frames with the lane follower driving
              (a DDIM-10 prediction every 50 frames once the ring is
              full), then 100 with the policy driving (a denoise every 5):
              one K2 launch a frame and the reset's, 50 K1 a denoise,
              nothing else; red overlay pixels in the last frame; the
              frames saved as .npy; frames/s;
  mfu         cli/mfu.py's rows: the denoiser forward in bf16 at B=256 on
              the default conv path and on the conv kernels (K1; K3-K5),
              the train step at B=16 in fp32 and amp; exact launches, every
              row's FLOP/s below the card's bf16 peak;
  profile     cli/train_policy.py --profile_dir over an epoch of two train
              steps, and bench --smoke --profile-dir in policy mode: each
              writes one Chrome trace, with K1's kernel among its device
              events;
  multi-device  two gloo ranks on the card (spawned; the kernels already
              built): r5blend's closed loop of 256 envs (128 a rank) on the
              4-track bank, DDIM-10 leading, 20 frames from a reset, render
              on, through rollout_policy_sharded with the keyed x_T: each
              rank exactly 200 K1 and 21 K2 launches, the gathered actions
              within ACTION_TOL of one process's run of the same 256 envs;
              two data-parallel steps of r5blend's recipe at B=256 (128 a
              rank) on the collected store against two one-process steps
              from the same weights and generator (losses within rtol
              1e-5, params within rtol 1e-3 / atol 1e-5, the attention key
              biases within 2 * lr a step, Adam's ceiling; the tensor
              closest to its limit named, the key biases reported apart);
              the same two steps on a world-size-1 NCCL group against the
              no-group steps; both again with NCCL and a rank a card where
              there are two or more cards (else it says so); each rank's
              frames/s and step ms with the card's name and power limit;
  zstd        the JAX package's shared eval store (data/eval_shared, blosc
              zstd-5 with bitshuffle, 1.33 GB decoded) read through the
              host library's zstd decoder: the six arrays, their shapes and
              MB/s; every `img` chunk encoded again by the host library's
              zstd encoder (blosc zstd-5, bitshuffle) and decoded by its
              decoder, equal: encode MB/s (host) and the bytes against
              c-blosc's on disk, beside the card's name and power limit;
              then cli/evaluate.py accuracy of r5blend (EMA, gaussian
              x_T, DDIM-10 leading, 120 windows) on it: K1 and nothing
              else, the error and windows/s beside the JAX record's
              (results/r5/acc_r5blend_ema.json, other weights: a
              reference, not a target);
Then one line holds the kernels as JSON (with the policy, env, loop,
collect, training, eval, UNetSimple, r4rn, autoencoder, native, sample,
run_predictions, mfu, profile, multi-device and zstd readings; the K1-K6
entries with
`launches_r4rn`, K3-K5 with `launches_unet_simple` and their UNetSimple
sums; K1 with `launches_sample_ddpm`, `launches_run_predictions` and
`launches_mfu`, K2 with `launches_run_predictions`, K3-K5 with
`launches_mfu`, K1 and K2 with `launches_sharded_loop` (each rank's), K1
with `launches_shared_accuracy`; each kernel's sums over one forward
or step in fp32, and in bf16 under "bf16"), one the card's name and power
limit, and the last line is {"ok": true, "device": {...}}. Any failed
check exits non-zero first.

TF32 is off for matmuls and cuDNN convolutions throughout
(torch.backends.cuda.matmul.allow_tf32 = False,
torch.backends.cudnn.allow_tf32 = False): fp32 here is full fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "artifacts", "r5blend_best")
GOLDEN = os.path.join(HERE, "tests", "fixtures", "golden_frames.npz")

N_ENVS, N_FRAMES, HEADS = 256, 50, 4
# (T, C) of the five kernel calls of one U-Net forward at width 64
ATTN_SHAPES = [(64, 128), (16, 256), (16, 128), (64, 64), (256, 64)]
# shapes K1 takes off r5blend's path, held against the plain version at
# B=256: those of a forward at --model_width 128 (its other two, (16, 256)
# and (64, 128), are r5blend's too); T=384, the top level of a 48x8 input
# (--pred_horizon 40), at widths 64 and 128; T not a multiple of 16 (Dh =
# 24 and 8) and Dh = 8 at T = 16; heads wider than 128 (the row path): Dh =
# 256 at width 256's (16, 1024) and at a ragged T, Dh = 160 at T = 64 and
# a ragged T
WIDE_ATTN_SHAPES = [(64, 256), (16, 512), (256, 128), (384, 64), (384, 128),
                    (20, 96), (200, 32), (16, 32), (16, 1024), (37, 1024),
                    (64, 640), (20, 640)]
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# exponentials a second: 132 SMs x 16 results a clock (the SFU's rate, CUDA
# C++ Programming Guide's throughput table, compute capability 9.0) x
# 1.98 GHz, the clock the 67 TFLOP/s fp32 peak implies (132 x 128 x 2 x f)
SFU_PER_S = 132 * 16 * 1.98e9
# K1 against its plain version: fp32 differs only in summation order and
# expf (~1e-6 at these magnitudes); bf16 may round p or the output one
# bf16 ulp apart (2**-7 at |x| < 2, 2**-6 below 4)
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# actions, kernel path vs plain path (fp32) and card vs CPU: the DDIM-10
# chain amplifies the ~1e-6 eps differences of two fp32 summation orders
# up to 157x at t=999 (tests/test_torch_policy.py holds chains to 2e-3 in
# normalized units); 1e-2 is 1% of the steering range
ACTION_TOL = 1e-2
# K1 against its plain version on the policy's own activations: max abs
# error over the call's largest output (see ShadowAttention); 2**-7 is one
# to two bf16 ulps of that output
K1_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# amp actions against the fp32 plain path: mean |diff| and the share of
# actions more than AMP_FAR apart. In bf16 a one-ulp difference in a few
# of K1's outputs moves the actions of the closed loop by up to ~0.3, so no
# max is held; on an H100 the kernel's run and the plain version's read
# mean 0.0113 / 0.0114 and share 0.044 / 0.045, and the limits are about
# twice that
AMP_FAR = 0.05
AMP_MEAN_TOL = 0.025
AMP_SHARE_TOL = 0.10

# (H, W, Cin, Cout, residual) of the 15 DoubleConvs of one r5blend U-Net
# forward that the conv-kernel path takes (Cin >= 8; the first, Cin=1, stays
# plain), in forward order: down blocks, bottleneck, up blocks. UNetFiLM
# has no residual DoubleConv (only UNetSimple's are). Each is two K3 calls
# ((Cin->Cout) and (Cout->Cout): mid == out), two K4 calls (GELU after the
# first conv, the affine after the second) and one K5 call. The policy
# phase checks this list against the shapes it sees.
DC_SHAPES = [(16, 4, 64, 64, False), (16, 4, 64, 128, False),
             (8, 2, 128, 128, False), (8, 2, 128, 256, False),
             (4, 1, 256, 256, False), (4, 1, 256, 256, False),
             (4, 1, 256, 512, False), (4, 1, 512, 512, False),
             (4, 1, 512, 256, False),
             (8, 2, 512, 512, False), (8, 2, 512, 128, False),
             (16, 4, 256, 256, False), (16, 4, 256, 64, False),
             (32, 8, 128, 128, False), (32, 8, 128, 64, False)]
# K3-K5 against their plain versions: max abs error over the largest output.
# fp32: two f32 summation orders of K = 9*Cin <= 4608 products differ by
# ~sqrt(K) * 2**-24 ~ 4e-6 of an output, inside K1's 1e-5; the norm keeps
# relative errors as they are. bf16: the same f32 values rounded once, one
# bf16 ulp (2**-7 at the top binade); K5 rounds in series (an ulp of its
# first conv's output feeds the second conv, whose output rounds again):
# two ulps
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
DC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}

# (H, W, Cin, Cout, residual) of the 12 DoubleConvs of one UNetSimple
# forward (width 16, a 1,350-wide cond: r5blend's horizons and conv-AE
# features) that the conv-kernel path takes at B=256 (Cin >= 8 and
# B*H*W >= 1024; DoubleConv_0, Cin=1, stays plain), in forward order: the
# three down blocks, then the three up blocks, each a residual DoubleConv
# (Cin -> Cin) and one to the block's width. The nets phase checks this
# list against the shapes its forward sees.
SIMPLE_DC_SHAPES = [(16, 4, 16, 16, True), (16, 4, 16, 32, False),
                    (8, 2, 64, 64, True), (8, 2, 64, 128, False),
                    (4, 1, 160, 160, True), (4, 1, 160, 256, False),
                    (8, 2, 448, 448, True), (8, 2, 448, 128, False),
                    (16, 4, 224, 224, True), (16, 4, 224, 64, False),
                    (32, 8, 112, 112, True), (32, 8, 112, 32, False)]
# DDIM-10 samples of UNetSimple, conv-kernel path against the default
# path, fp32: tests/test_torch_policy.py's CHAIN_ATOL for two fp32
# implementations of one net (the chain amplifies ~1e-6 in eps by up to
# 157x), in normalized units
SIMPLE_CHAIN_TOL = 2e-3
R4RN_DIR = os.path.join(HERE, "artifacts", "r4rn_best")
R3_DIR = os.path.join(HERE, "artifacts", "r3_autoencoder")
# r3's reconstructions of the golden frames, card against CPU, fp32 (TF32
# off): cuDNN may take Winograd or FFT algorithms for fp32 convs, whose
# rounding reaches ~1e-5 of the operands; the outputs are sigmoids in (0, 1)
AE_TOL = 1e-4
AE_EPOCHS, AE_BATCH = 2, 128

GOLDEN_STATES = os.path.join(HERE, "tests", "fixtures", "golden_states.pkl")
K2_PIXELS = 72 * 128
# frames: at most 30 of 27,648 bytes may differ (tests/test_render_golden.py):
# the polygon edge test compares a float32 cross product with 1e-6, and an
# ulp of a vertex moves edge pixels
FRAME_BUDGET = 30
# env on the card against the CPU: 16 envs x 40 steps. CUDA's sin, cos and
# atan2 differ from the CPU's by an ulp on some angles and the steps
# compound that; 1e-3 world units (1.5e-6 of the playfield's width) is
# ~100x what 40 steps give on an H100 (7.6e-6) and ~250x the CPU against
# JAX (tests/test_torch_env.py: 3.8e-6), and far below the 6.67-unit road
# half-width that decides the tile counts held equal here
ENV_POS_TOL = 1e-3
ENV_B, ENV_STEPS, ENV_TRACKS, ENV_REPEATS = 1024, 200, 16, 2
LOOP_TRACKS, DRIVE_FRAMES = 4, 500


class Failed(Exception):
    pass


def phase(name):
    """Context manager printing `[phase] name ... s` around a block."""

    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[phase] {name}: start", flush=True)
            return self

        def __exit__(self, exc_type, exc, tb):
            dt = time.perf_counter() - self.t0
            status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
            print(f"[phase] {name}: {status} in {dt:.2f} s", flush=True)
            return False

    return _P()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn(): `iters` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost
    (tens of microseconds a wrapper call) does not pad small kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise Failed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def k1_floor_ms(B, T, C, dtype, heads=HEADS):
    """(bytes ms, operations ms, exponentials ms) of one K1 call: q, k, v
    read once and out written once, over the memory rate; 4*T*T*C flops
    per batch element over the peak rate for the inputs' type; one
    exponential a score, B*heads*T*T, over the SFU's rate."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return (4 * B * T * C * itemsize / HBM_BYTES_PER_S * 1e3,
            4 * B * T * T * C / PEAK_OPS[dtype] * 1e3,
            B * heads * T * T / SFU_PER_S * 1e3)


def bound(byte_ms, op_ms):
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def conv_taps(W):
    """The taps of a 3x3 same-padded conv (or its weight gradient) that
    can touch the image: all nine, but where W == 1 the columns dj = 0 and
    2 lie wholly in the zero halo, so the function needs only three."""
    return 3 if W == 1 else 9


def check_k1(cuda_ops, device, build):
    """Phase 3: K1 alone, at B=256: the five shapes of a forward and the
    shapes off r5blend's path (WIDE_ATTN_SHAPES), fp32 and bf16, each
    against its plain version, twice (bit-identical), timed beside its
    plain version and SDPA. Returns (per-call records, ptxas lines)."""
    import torch.nn.functional as F

    ptxas = print_ptxas(build, "attention_core", ("attention_core",))
    no_spills(ptxas, "attention_core_kernel_rows", "K1's row kernel")
    gen = torch.Generator(device=device).manual_seed(1234)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for T, C in ATTN_SHAPES + WIDE_ATTN_SHAPES:
            q, k, v = (torch.randn((N_ENVS, T, C), generator=gen,
                                   device=device).to(dtype)
                       for _ in range(3))
            got = cuda_ops.attention_core_cuda(q, k, v, HEADS)
            again = cuda_ops.attention_core_cuda(q, k, v, HEADS)
            want = cuda_ops.attention_core_ref(q, k, v, HEADS)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (err <= K1_TOL[dtype]):
                raise Failed(f"K1 {dtype} T={T} C={C}: max abs err {err} > "
                             f"{K1_TOL[dtype]}")
            if not torch.equal(got, again):
                raise Failed(f"K1 {dtype} T={T} C={C}: two runs differ")
            del want, again
            Dh = C // HEADS
            qh, kh, vh = (t.reshape(N_ENVS, T, HEADS, Dh).transpose(1, 2)
                          .contiguous() for t in (q, k, v))
            ms = graph_ms(lambda: cuda_ops.attention_core_cuda(q, k, v, HEADS),
                         20)
            plain_ms = graph_ms(
                lambda: cuda_ops.attention_core_ref(q, k, v, HEADS), 10)
            lib_ms = graph_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
            byte_ms, op_ms, exp_ms = k1_floor_ms(N_ENVS, T, C, dtype)
            bound_ms = max(byte_ms, op_ms, exp_ms)
            # the exponentials are operations too (on the SFU)
            term = ("bytes" if bound_ms == byte_ms else "operations"
                    if bound_ms == op_ms else "exponentials")
            rec = dict(T=T, C=C, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err, tol=K1_TOL[dtype], ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       byte_ms=byte_ms, op_ms=op_ms, exp_ms=exp_ms,
                       bound_ms=bound_ms,
                       bound_by="bytes" if term == "bytes" else "operations",
                       bound_term=term,
                       bound_ms_two_term=max(byte_ms, op_ms),
                       r5blend=(T, C) in ATTN_SHAPES,
                       plan=cuda_ops.attention_core_plan(N_ENVS, T, HEADS, Dh,
                                                         dtype))
            records.append(rec)
            print(f"  K1 {rec['dtype']:8s} B={N_ENVS} T={T:3d} C={C:3d}: "
                  f"err {err:.3e} (tol {K1_TOL[dtype]:.1e}), repeat equal; "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
                  f"{lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({term}; bytes "
                  f"{byte_ms:.4f}, operations {op_ms:.4f}, exponentials "
                  f"{exp_ms:.4f}; two-term {rec['bound_ms_two_term']:.4f})  "
                  f"plan {rec['plan']}", flush=True)
    for dtype in ("float32", "bfloat16"):
        fwd = [r for r in records if r["dtype"] == dtype and r["r5blend"]]
        print(f"  K1 {dtype} one forward (the five calls): kernel "
              f"{sum(r['ms'] for r in fwd):.4f} ms, sdpa "
              f"{sum(r['library_ms'] for r in fwd):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in fwd):.4f} ms (two-term "
              f"{sum(r['bound_ms_two_term'] for r in fwd):.4f})", flush=True)
    return records, ptxas


def check_k1_unets(cuda_ops, device, seed):
    """K1 on U-Net forwards off r5blend's path, random init, B=64: widths
    128 and 256 (whose (16, 1024) call has heads of 256, the row path) on
    r5blend's 32x8 input, and width 64 on the 48x8 input of a
    --pred_horizon 40 plan (41 rows, padded). Each forward runs on the
    kernel path (exactly 5 K1 launches) and on the plain path with K1
    held against it on the forward's own activations (ShadowAttention,
    within K1_REL_TOL), in fp32 and in bf16."""
    from state_policy_diffusionmodel_torch.diffusion import PolicyConfig
    from state_policy_diffusionmodel_torch.diffusion.policy import \
        init_module_
    from state_policy_diffusionmodel_torch.models import build_model

    B, out = 64, {}
    for tag, width, horizon in (("width 128", 128, 31),
                                ("width 256", 256, 31),
                                ("48-row input", 64, 41)):
        cfg = PolicyConfig(model_width=width, pred_horizon=horizon - 1)
        gen = torch.Generator(device=device).manual_seed(seed + width)
        unet = init_module_(build_model(
            cfg.model, cfg.obs_horizon * cfg.observation_dim, out_channels=1,
            width=width).to(device), gen)
        x = torch.randn((B, horizon, cfg.prediction_dim, 1), generator=gen,
                        device=device)
        cond = torch.randn((B, cfg.obs_horizon * cfg.observation_dim),
                           generator=gen, device=device)
        t = torch.randint(0, cfg.noise_steps, (B,), generator=gen,
                          device=device)
        for dtype in (torch.float32, torch.bfloat16):
            net = unet if dtype == torch.float32 else \
                copy.deepcopy(unet).to(dtype)
            with torch.no_grad():
                before = cuda_ops.attention_core.launches
                got = net(x.to(dtype), t, cond.to(dtype))
                torch.cuda.synchronize()
                launches = cuda_ops.attention_core.launches - before
                shadow = ShadowAttention(cuda_ops)
                with mock.patch.object(cuda_ops, "attention_core", shadow):
                    want = net(x.to(dtype), t, cond.to(dtype))
            torch.cuda.synchronize()
            name = f"{tag} {str(dtype).replace('torch.', '')}"
            real = shadow.summary()
            gap = rel_err(got, want)[1].item()
            out[name] = dict(k1_launches=launches, k1_on_forward=real,
                             output_gap=gap)
            print(f"  {name}: K1 launches {launches}; K1 vs plain on the "
                  f"forward's activations ({real['calls']} calls): "
                  f"{fmt(real)}; output, kernel path vs plain path: max "
                  f"err {gap:.3e} of the largest", flush=True)
            if launches != 5 or real["calls"] != 5:
                raise Failed(f"{name}: {launches} K1 launches, "
                             f"{real['calls']} shadowed, expected 5")
            if not real["max_rel_err"] <= K1_REL_TOL[dtype]:
                raise Failed(f"{name}: K1 differs from its plain version by "
                             f"{real['max_rel_err']} of the largest output "
                             f"> {K1_REL_TOL[dtype]}")
            if tuple(got.shape) != tuple(x.shape) or \
                    not torch.isfinite(got).all():
                raise Failed(f"{name}: output {tuple(got.shape)} or "
                             "non-finite")
    return out


def conv_calls(shapes=None):
    """(H, W, Cin, Cout) of the K3 calls of one forward, in order: 30 of
    r5blend's (DC_SHAPES), or of the DoubleConvs `shapes`."""
    return [c for H, W, cin, cout, _ in shapes or DC_SHAPES
            for c in ((H, W, cin, cout), (H, W, cout, cout))]


def gn_calls(shapes=None):
    """(H, W, C, variant) of the K4 calls of one forward, in order: 30 of
    r5blend's (DC_SHAPES), or of the DoubleConvs `shapes`."""
    return [c for H, W, _, cout, res in shapes or DC_SHAPES
            for c in ((H, W, cout, "gelu"),
                      (H, W, cout, "post_res" if res else "post"))]


def rel_err(got, want):
    """(max abs error, that error over the largest |want|), on the card."""
    err = (got.float() - want.float()).abs().max()
    return err, err / want.float().abs().max().clamp_min(1e-30)


def itemsize(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def check_kernel(name, records, key, got, want, tol, dtype, **fields):
    """Hold one kernel call against its plain version by the error over
    the largest output; returns the record (fields + errors) it appends."""
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    err, rel = err.item(), rel.item()
    if not (rel <= tol[dtype]):
        raise Failed(f"{name} {dtype} {key}: max abs err {err} = {rel} of "
                     f"the largest output > {tol[dtype]}")
    rec = dict(fields, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=err, max_rel_err=rel, tol=tol[dtype])
    records.append(rec)
    return rec


def timed(rec, kernel, plain, library=None, iters=20):
    """Add the kernel's, the plain version's and the library call's graph
    times to rec."""
    rec["ms"] = graph_ms(kernel, iters)
    rec["plain_ms"] = graph_ms(plain, iters)
    rec["library_ms"] = None if library is None else graph_ms(library, iters)


def ptxas_report(log: str, names=("conv3x3_", "conv_dw_")) -> list[dict]:
    """Registers, static shared memory and spills of each kernel whose name
    holds one of `names`, from nvcc's `-Xptxas -v` output (build.Built.log),
    names demangled by c++filt where the machine has one."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = dict(kernel=m.group(1)) if any(
                n in m.group(1) for n in names) else None
            if cur is not None:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur["registers"] = int(m.group(1))
            cur["static_smem"] = int(smem.group(1)) if smem else 0
    demangler = shutil.which("c++filt") or shutil.which("cu++filt")
    if rows and demangler:
        out = subprocess.run([demangler], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                r["kernel"] = re.sub(r"\(anonymous namespace\)::|\(.*", "",
                                     name).replace("void ", "")
    return rows


def print_ptxas(build, lib: str,
                names=("conv3x3_", "conv_dw_")) -> list[dict]:
    """Print (and return) the ptxas line of each kernel of library `lib`
    whose name holds one of `names`; fails where the build's log reports
    none."""
    rows = ptxas_report(build.build_all([lib])[lib].log, names)
    if not rows:
        raise Failed(f"{lib}: nvcc's log reports no kernel (ptxas -v)")
    for r in rows:
        print(f"  ptxas {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('static_smem')} B static smem, spills "
              f"{r.get('spill_stores')} / {r.get('spill_loads')} B "
              "(stores / loads)", flush=True)
    return rows


def no_spills(rows, name, what):
    """Fail where a kernel of `rows` whose name holds `name` spills
    registers."""
    bad = [r for r in rows if name in r["kernel"]
           and (r.get("spill_stores") or r.get("spill_loads"))]
    if bad:
        raise Failed(f"{what} spills registers: {bad}")


def fmt_ms(ms):
    return "-" if ms is None else f"{ms:.4f}"


def check_k3(cuda_ops, device, build, calls=None):
    """K3 alone at the 17 distinct conv shapes of the forward (or of
    `calls`), fp32 and
    bf16: against its plain version, twice (bit-identical), with its time,
    the plain version's, cuDNN's (F.conv2d on the channels-last views of x
    and w, TF32 off), the bound of the taps the conv needs (three where
    W == 1; the nine-tap bound beside it), the achieved TFLOP/s of those
    taps and the plan (with the ring depth the launcher takes); first the
    ptxas line of each kernel. Returns per-shape records and the ptxas
    rows."""
    import torch.nn.functional as F

    ptxas = print_ptxas(build, "conv3x3")
    gen = torch.Generator(device=device).manual_seed(4321)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, cin, cout in dict.fromkeys(calls or conv_calls()):
            x = torch.randn((N_ENVS, H, W, cin), generator=gen,
                            device=device).to(dtype)
            w = (torch.randn((cout, cin, 3, 3), generator=gen, device=device)
                 * (2.0 / (9 * cin)) ** 0.5).to(dtype)
            key = f"{H}x{W} {cin}->{cout}"
            got = cuda_ops.conv3x3_cuda(x, w)
            again = cuda_ops.conv3x3_cuda(x, w)
            rec = check_kernel("K3", records, key, got,
                               cuda_ops.conv3x3_ref(x, w), CONV_TOL, dtype,
                               H=H, W=W, Cin=cin, Cout=cout)
            if not torch.equal(got, again):
                raise Failed(f"K3 {dtype} {key}: two runs differ")
            plan = cuda_ops.conv3x3_plan(N_ENVS, H, W, cin, cout, dtype,
                                         cuda_ops._n_sm(device))
            rec["plan"] = dict(route="mma" if plan.mma else "cuda cores",
                               bm=plan.bm, bn=plan.bn, taps=plan.taps,
                               ring=cuda_ops.conv3x3_ring(plan, W),
                               splits=plan.splits, blocks=plan.blocks)
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.contiguous(memory_format=torch.channels_last)
            timed(rec, lambda: cuda_ops.conv3x3_cuda(x, w),
                  lambda: cuda_ops.conv3x3_ref(x, w),
                  lambda: F.conv2d(x_cl, w_cl, padding=1))
            M = N_ENVS * H * W
            byte_ms = (x.numel() + w.numel() + M * cout) * itemsize(dtype) \
                / HBM_BYTES_PER_S * 1e3
            tap_ms = 2 * M * cin * cout / PEAK_OPS[dtype] * 1e3
            taps = conv_taps(W)
            rec["bound_ms"], rec["bound_by"] = bound(byte_ms, taps * tap_ms)
            rec["bound_ms_9taps"] = max(byte_ms, 9 * tap_ms)
            rec["bound_ms_taps_computed"] = max(byte_ms, plan.taps * tap_ms)
            rec["tflops"] = 2 * M * taps * cin * cout / rec["ms"] / 1e9
            print(f"  K3 {rec['dtype']:8s} {key:16s}: rel err "
                  f"{rec['max_rel_err']:.2e}, repeat equal  kernel "
                  f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s)  plain "
                  f"{rec['plain_ms']:.4f}  cuDNN {rec['library_ms']:.4f}  "
                  f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}, {taps} "
                  f"taps; 9 taps {rec['bound_ms_9taps']:.4f})  "
                  f"plan {rec['plan']}", flush=True)
    return records, ptxas


def gn_inputs(B, H, W, C, dtype, gen, device):
    """x, gamma, beta, ps, pb, x_res for K4, on the card."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=device)
    return [t.to(dtype) for t in (
        2 * r(B, H, W, C) + 0.5, 1 + 0.3 * r(C), 0.2 * r(C),
        1 + 0.2 * r(B, C), 0.3 * r(B, C), r(B, H, W, C))]


GN_VARIANTS = {"gn": lambda x, g, b, ps, pb, xr: (x, g, b),
               "gelu": lambda x, g, b, ps, pb, xr: (x, g, b, None, None,
                                                    None, True),
               "post": lambda x, g, b, ps, pb, xr: (x, g, b, ps, pb),
               "post_res": lambda x, g, b, ps, pb, xr: (x, g, b, ps, pb, xr)}


def check_k4(cuda_ops, device, build, calls=None):
    """K4 alone at the 10 distinct conv-output shapes of the forward (or of
    `calls`), in
    its four variants, fp32 and bf16: against its plain version, twice
    (bit-identical), with its plan, its time (the median of three
    readings), the plain version's,
    F.group_norm's for the `gn` variant (the one PyTorch call computing
    GroupNorm alone, channels-last; timed as a yardstick only) and the
    bound (bytes: x [and x_res] read once, the output written once); first
    the ptxas line of each kernel (no spills). Returns (per-case records,
    ptxas rows)."""
    import torch.nn.functional as F

    ptxas = print_ptxas(build, "gn_act", ("gn_act_kernel",))
    no_spills(ptxas, "gn_act_kernel", "K4")
    gen = torch.Generator(device=device).manual_seed(8765)
    records = []
    calls = calls or gn_calls()
    shapes = dict.fromkeys((H, W, C) for H, W, C, _ in calls)
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, C in shapes:
            inputs = gn_inputs(N_ENVS, H, W, C, dtype, gen, device)
            plan = cuda_ops.gn_act_plan(N_ENVS, H * W, C, dtype)
            for variant, pick in GN_VARIANTS.items():
                a = pick(*inputs)
                key = f"{H}x{W}x{C} {variant}"
                got = cuda_ops.gn_act_cuda(*a)
                again = cuda_ops.gn_act_cuda(*a)
                rec = check_kernel("K4", records, key, got,
                                   cuda_ops.gn_act_ref(*a), CONV_TOL, dtype,
                                   H=H, W=W, C=C, variant=variant)
                if not torch.equal(got, again):
                    raise Failed(f"K4 {dtype} {key}: two runs differ")
                rec["plan"] = dataclasses.asdict(plan)
                x_nchw = a[0].permute(0, 3, 1, 2)
                kernel = lambda: cuda_ops.gn_act_cuda(*a)
                # the median of three readings of 100 calls a graph, since
                # the small calls take 3-4 us and a reading now and then
                # runs long
                rec["ms"] = sorted(graph_ms(kernel, 100) for _ in range(3))[1]
                rec["plain_ms"] = graph_ms(
                    lambda: cuda_ops.gn_act_ref(*a), 20)
                rec["library_ms"] = (graph_ms(lambda: F.group_norm(
                    x_nchw, 1, a[1], a[2], eps=cuda_ops.GN_EPS), 20)
                    if variant == "gn" else None)
                n = N_ENVS * H * W * C
                n_bytes = ((2 + (variant == "post_res")) * n + 2 * C
                           + 2 * N_ENVS * C * (variant.startswith("post"))
                           ) * itemsize(dtype)
                rec["bound_ms"], rec["bound_by"] = bound(
                    n_bytes / HBM_BYTES_PER_S * 1e3,
                    10 * n / PEAK_OPS[torch.float32] * 1e3)
                print(f"  K4 {rec['dtype']:8s} {key:18s}: rel err "
                      f"{rec['max_rel_err']:.2e}, repeat equal  kernel "
                      f"{rec['ms']:.4f} ms  "
                      f"plain {rec['plain_ms']:.4f}  group_norm "
                      f"{fmt_ms(rec['library_ms'])}  bound "
                      f"{rec['bound_ms']:.4f} ({rec['bound_by']})  plan "
                      f"{plan}", flush=True)
    for dtype in ("float32", "bfloat16"):
        fwd = per_forward(records, calls,
                          lambda r: (r["H"], r["W"], r["C"], r["variant"]),
                          dtype)
        print(f"  K4 {dtype} one forward ({len(calls)} calls): kernel "
              f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, bound "
              f"{fwd['bound_ms']:.4f} ms", flush=True)
    return records, ptxas


def dc_inputs(H, W, cin, cout, dtype, gen, device):
    """x, w1, w2, g1, b1, g2, b2, ps, pb of one DoubleConv on the card:
    He-scaled OIHW weights, one norm for both (mid == out, the shared-norm
    quirk), the affine away from identity as FiLM makes it."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=device)
    g, b = 1 + 0.3 * r(cout), 0.2 * r(cout)
    return [t.to(dtype) for t in (
        r(N_ENVS, H, W, cin), r(cout, cin, 3, 3) * (2 / (9 * cin)) ** 0.5,
        r(cout, cout, 3, 3) * (2 / (9 * cout)) ** 0.5, g, b, g, b,
        1 + 0.2 * r(N_ENVS, cout), 0.3 * r(N_ENVS, cout))]


def check_k5(cuda_ops, device, shapes=None):
    """K5 at the 14 distinct DoubleConv shapes of the forward (or at
    `shapes`), fp32 and bf16: against its plain version, twice
    (bit-identical), with its time, the plain version's and
    the bound of the whole block (x, the weights, the vectors read once, the
    output written once; both convs' operations at the taps they need).
    Returns records."""
    gen = torch.Generator(device=device).manual_seed(2468)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, cin, cout, res in dict.fromkeys(shapes or DC_SHAPES):
            a = dc_inputs(H, W, cin, cout, dtype, gen, device) + [res]
            key = f"{H}x{W} {cin}->{cout}{' res' if res else ''}"
            got = cuda_ops.double_conv_cuda(*a)
            rec = check_kernel("K5", records, key, got,
                               cuda_ops.double_conv_ref(*a), DC_TOL, dtype,
                               H=H, W=W, Cin=cin, Cout=cout, residual=res)
            if not torch.equal(got, cuda_ops.double_conv_cuda(*a)):
                raise Failed(f"K5 {dtype} {key}: two runs differ")
            timed(rec, lambda: cuda_ops.double_conv_cuda(*a),
                  lambda: cuda_ops.double_conv_ref(*a), iters=10)
            M = N_ENVS * H * W
            n_bytes = (sum(t.numel() for t in a[:-1]) + M * cout) \
                * itemsize(dtype)
            flops = 2 * M * conv_taps(W) * (cin + cout) * cout
            rec["bound_ms"], rec["bound_by"] = bound(
                n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_OPS[dtype] * 1e3)
            print(f"  K5 {rec['dtype']:8s} {key:20s}: rel err "
                  f"{rec['max_rel_err']:.2e}  kernel {rec['ms']:.4f} ms  "
                  f"plain {rec['plain_ms']:.4f}  bound {rec['bound_ms']:.4f}"
                  f" ({rec['bound_by']})", flush=True)
    return records


class ShadowDoubleConv:
    """double_conv that returns the plain version and, where K5 would run,
    runs the kernels on the same inputs: K3 and K4 at each of their four
    stages, each on the plain version's own input to that stage, and K5
    whole. Records each one's max abs error over the largest output, and
    the DoubleConv shapes it saw. The records stay on the card until
    summary()."""

    def __init__(self, cuda_ops):
        self.ops = cuda_ops
        self.calls = 0
        self.rel = {"K3": [], "K4": [], "K5": []}
        self.shapes = set()

    def __call__(self, x, w1, w2, g1, b1, g2, b2, ps, pb, residual=False):
        ops = self.ops
        xres = x if residual else None
        h0 = ops.conv3x3_ref(x, w1).contiguous()
        h = ops.gn_act_ref(h0, g1, b1, gelu=True)
        y0 = ops.conv3x3_ref(h, w2).contiguous()
        out = ops.gn_act_ref(y0, g2, b2, ps, pb, xres)
        if ops.takes_conv_kernel(x, min(x.shape[3], w1.shape[0])):
            self.calls += 1
            self.shapes.add((x.shape[1], x.shape[2], x.shape[3], w2.shape[0],
                             residual))
            rel = lambda got, want: rel_err(got, want)[1]
            self.rel["K3"] += [rel(ops.conv3x3_cuda(x, w1), h0),
                               rel(ops.conv3x3_cuda(h, w2), y0)]
            self.rel["K4"] += [rel(ops.gn_act_cuda(h0, g1, b1, gelu=True), h),
                               rel(ops.gn_act_cuda(y0, g2, b2, ps, pb, xres),
                                   out)]
            self.rel["K5"].append(rel(ops.double_conv_cuda(
                x, w1, w2, g1, b1, g2, b2, ps, pb, residual), out))
        return out

    def summary(self):
        return dict(calls=self.calls, **{
            f"{k}_max_rel_err": torch.stack(v).max().item()
            for k, v in self.rel.items()})


def observation_stream(stats, seed, device):
    """(obs (F, B, 96, 96, 3) uint8, pos (F, B, 2), vel (F, B, 2)) on the
    card: the six golden frames cycled in a per-env order, positions and
    velocities drawn from `seed` within the run's stats."""
    rng = np.random.default_rng(seed)
    with np.load(GOLDEN) as g:
        frames = np.stack([g[f"f{i}_obs"] for i in range(6)])
    order = np.stack([rng.permutation(6) for _ in range(N_ENVS)])
    idx = order[:, np.arange(N_FRAMES) % 6].T                # (F, B)
    obs = frames[idx]
    pmin = float(np.min(stats["position"]["min"]))
    pmax = float(np.max(stats["position"]["max"]))
    vlo = np.asarray(stats["velocity"]["min"], np.float32)
    vhi = np.asarray(stats["velocity"]["max"], np.float32)
    vel = rng.uniform(vlo, vhi, size=(N_FRAMES, N_ENVS, 2)).astype(np.float32)
    pos0 = rng.uniform(pmin, pmax, size=(N_ENVS, 2)).astype(np.float32)
    pos = pos0 + 0.02 * np.cumsum(vel, axis=0)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return to(obs), to(pos.astype(np.float32)), to(vel)


def rollout(policy_fn, params, carry, stream, n_frames):
    obs, pos, vel = stream
    actions = []
    for f in range(n_frames):
        a, carry = policy_fn(params, carry, obs[f], pos[f], vel[f])
        actions.append(a)
    return torch.stack(actions), carry


def spread(a, b):
    """max and mean |a - b| over all actions, and the share over AMP_FAR."""
    d = (a - b).abs()
    return dict(max=d.max().item(), mean=d.mean().item(),
                share_over=(d > AMP_FAR).float().mean().item())


def fmt(rec):
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in rec.items())


def takes_kernel(q, num_heads):
    _, T, C = q.shape
    return T >= 16 and C // num_heads >= 8


class ShadowAttention:
    """attention_core that returns the plain version and, where the kernel
    would run, launches the kernel on the same inputs and records how far
    apart they are: max abs error, that error over the call's largest
    output, and the share of outputs that differ at all. The records stay
    on the card until summary()."""

    def __init__(self, cuda_ops):
        self.ops = cuda_ops
        self.calls, self.n = 0, 0
        self.err, self.rel, self.differ = [], [], []

    def __call__(self, q, k, v, num_heads=1):
        want = self.ops.attention_core_ref(q, k, v, num_heads)
        if q.is_cuda and takes_kernel(q, num_heads):
            got = self.ops.attention_core_cuda(q, k, v, num_heads)
            self.calls += 1
            err = (got.float() - want.float()).abs().max()
            self.err.append(err)
            self.rel.append(err / want.float().abs().max().clamp_min(1e-30))
            self.differ.append((got != want).sum())
            self.n += got.numel()
        return want

    def summary(self):
        return dict(calls=self.calls,
                    max_abs_err=torch.stack(self.err).max().item(),
                    max_rel_err=torch.stack(self.rel).max().item(),
                    share_differ=torch.stack(self.differ).sum().item()
                    / self.n)


class NudgedAttention:
    """The plain attention_core with one bf16 ulp added to or taken from a
    random `share` of the outputs of each call the kernel would take."""

    def __init__(self, cuda_ops, share, seed, device):
        self.ops, self.share = cuda_ops, share
        self.gen = torch.Generator(device=device).manual_seed(seed + 7)

    def __call__(self, q, k, v, num_heads=1):
        out = self.ops.attention_core_ref(q, k, v, num_heads)
        if out.dtype != torch.bfloat16 or not takes_kernel(q, num_heads):
            return out
        bits = out.view(torch.int16)
        pick = (torch.rand(out.shape, generator=self.gen, device=out.device)
                < self.share) & ((bits & 0x7FFF) != 0)
        up = torch.rand(out.shape, generator=self.gen, device=out.device) < 0.5
        step = torch.where(up, 1, -1).to(torch.int16) * pick.to(torch.int16)
        return (bits + step).view(torch.bfloat16)


def k2_bound(tex, ids, c, s, pos, rx, ry):
    """(bound ms, side, distinct texels, bytes) of one K2 call on these
    inputs: the output written once (int32), each input read once, and of
    the bank only the distinct texels under the in-field pixels; ~12 flops
    a pixel at the float32 rate."""
    from state_policy_diffusionmodel_torch.render import cuda_sampler

    B, T = ids.shape[0], tex.shape[-1]
    fx, fy = cuda_sampler.texel_coords(c, s, pos, rx, ry, T)
    infield = (fx >= 0) & (fx < T) & (fy >= 0) & (fy < T)
    fi = fx.floor().to(torch.int64).clamp(0, T - 1)
    fj = fy.floor().to(torch.int64).clamp(0, T - 1)
    key = (ids.to(torch.int64)[:, None, None] * T + fi) * T + fj
    texels = int(torch.unique(key[infield]).numel())
    n_bytes = B * K2_PIXELS * 4 + texels + B * (4 + 4 + 4 + 8) \
        + 2 * K2_PIXELS * 4
    ms, side = bound(n_bytes / HBM_BYTES_PER_S * 1e3,
                     B * K2_PIXELS * 12 / PEAK_OPS[torch.float32] * 1e3)
    return ms, side, texels, n_bytes


def check_k2(cases, build=None):
    """K2 against its plain version on each named case of inputs: every
    int32 output equal, twice (bit-identical), with its grid, its time (the
    mean of two readings), the plain version's and the bound; given
    `build`, first the ptxas
    line of each kernel (no spills). Returns (per-case records, ptxas
    rows)."""
    from state_policy_diffusionmodel_torch.models.cuda_ops import _n_sm
    from state_policy_diffusionmodel_torch.render import cuda_sampler as ks

    ptxas = []
    if build is not None:
        ptxas = print_ptxas(build, "sample_banked", ("sample_banked",))
        no_spills(ptxas, "sample_banked", "K2")
    records = []
    for name, args in cases:
        before = ks.sample_banked.launches
        got = ks.sample_banked_cuda(*args)
        again = ks.sample_banked_cuda(*args)
        want = ks.sample_banked_ref(*args)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        err = int((got - want).abs().max())
        if mismatches:
            raise Failed(f"K2 {name}: {mismatches} outputs differ from the "
                         "plain version")
        if not torch.equal(got, again):
            raise Failed(f"K2 {name}: two runs differ")
        kernel = lambda: ks.sample_banked_cuda(*args)
        k1, k2 = (graph_ms(kernel, 50) for _ in range(2))
        plain_ms = graph_ms(lambda: ks.sample_banked_ref(*args), 10)
        bound_ms, side, texels, n_bytes = k2_bound(*args)
        # the check (twice), 3 warm-up calls and 50 captured in each of the
        # two timing graphs
        launches = ks.sample_banked.launches - before
        B = int(args[1].shape[0])
        groups = ks.sample_banked_plan(B, _n_sm(args[0].device))
        rec = dict(case=name, B=B, launches=launches,
                   mismatches=mismatches, max_abs_err=err, ms=(k1 + k2) / 2,
                   plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=side, texels=texels,
                   bytes=n_bytes, in_field=float((want > 0).float().mean()),
                   grid=groups * ks.STRIPS)
        records.append(rec)
        print(f"  K2 {name}: B={B}, 0 of {got.numel()} outputs differ, "
              f"repeat equal; kernel {rec['ms']:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({side}: {n_bytes / 1e6:.1f} MB, "
              f"{texels} distinct texels); grid {rec['grid']} CTAs; {launches} "
              "launches "
              "in this check", flush=True)
    return records, ptxas


def k2_cases(seed, device):
    """K2's named cases on the 16-track bank: random poses (edges and off
    the field included) and the env's own poses after 50 steps of seeded
    actions, each at the env bench's 1,024 envs and the closed loop's
    256."""
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.render import raster
    from state_policy_diffusionmodel_torch.track import load_or_build_bank

    bank = load_or_build_bank(ENV_TRACKS, bake=True, device=device)
    _, _, rx, ry = raster.pixel_planes(device)
    ids = torch.arange(ENV_B, dtype=torch.int32, device=device) % ENV_TRACKS
    st = vector.init_batch(bank, ids, device=device)
    st, _ = vector.rollout_constant(
        st, bank, env_actions(1, ENV_B, seed)[0].to(device), 50,
        render=False, track_ids=ids, device=device)
    cases = []
    for name, scal in (("random poses", random_poses(ENV_B, device, seed)),
                       ("env poses after 50 steps",
                        raster.camera_scalars(st.car))):
        for B in (ENV_B, N_ENVS):
            cut = tuple(t[:B].contiguous() for t in (ids, *scal))
            cases.append((name if B == ENV_B else f"{name}, closed-loop batch",
                          (bank.tex, *cut, rx, ry)))
    return cases


def random_poses(B, device, seed):
    """Camera scalars over the whole playfield, 10% beyond its edges."""
    from state_policy_diffusionmodel_torch.track import PLAYFIELD

    gen = torch.Generator().manual_seed(seed)
    ang = torch.rand(B, generator=gen) * (2 * np.pi) - np.pi
    pos = (torch.rand((B, 2), generator=gen) * 2 - 1) * (1.1 * PLAYFIELD)
    pos[:8] = torch.tensor([[PLAYFIELD, 0.0], [-PLAYFIELD, 50.0],
                            [0.0, PLAYFIELD], [10.0, -PLAYFIELD],
                            [PLAYFIELD, PLAYFIELD], [PLAYFIELD + 40, 0.0],
                            [-900.0, 0.0], [0.0, 700.0]])
    return (torch.cos(ang).to(device), torch.sin(ang).to(device),
            pos.to(device))


def env_actions(n_steps, B, seed):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-0.4, 0.4, (n_steps, B)),
                  rng.uniform(0.3, 1.0, (n_steps, B)),
                  rng.choice([0.0, 0.0, 0.0, 0.4], (n_steps, B))], -1)
    return torch.from_numpy(a.astype(np.float32))


def env_trace(device, B, n_steps, seed):
    """B envs on the 4-track bank, n_steps of seeded actions: per step the
    rewards, done flags, tile counts, positions and both frames, on the
    host."""
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.track import load_or_build_bank

    bank = load_or_build_bank(4, bake=True, device=device)
    ids = (torch.arange(B) % 4).to(torch.int32).to(device)
    acts = env_actions(n_steps, B, seed).to(device)
    st, _ = vector.reset_batch(bank, track_ids=ids, device=device)
    out = []
    for k in range(n_steps):
        st, res = vector.step_batch(st, bank, acts[k], track_ids=ids,
                                    device=device)
        out.append([t.cpu() for t in (res.reward, res.done, st.tile_count,
                                      st.car.pos, res.obs, res.augmented)])
    return out


def frame_bytes(a, b):
    """Per frame, the count of bytes that differ."""
    return (a != b).reshape(a.shape[0], -1).sum(-1)


def per_forward(records, calls, key, dtype="float32"):
    """Sums over one forward's calls (fp32 unless `dtype` says otherwise) of
    each timing and bound, from the records of the distinct shapes; the
    bound labelled by the side that sets most of the summed bound."""
    by_key = {key(r): r for r in records if r["dtype"] == dtype}
    rows = [by_key[c] for c in calls]
    out = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "bound_ms_9taps",
                     "bound_ms_taps_computed", "byte_ms", "op_ms", "exp_ms",
                     "bound_ms_two_term") if k in rows[0]}
    out["library_ms"] = (None if rows[0]["library_ms"] is None
                         else sum(r["library_ms"] for r in rows))
    side = {b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b)
            for b in ("bytes", "operations")}
    out["bound_by"] = max(side, key=side.get)
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def conv_kernel_entries(k3, k4, k5, runs, loop):
    """The kernels line's K3-K5 entries: one forward's calls at B=256 in
    fp32 (the main path's) and in bf16 (amp's) summed, launches from the
    fp32 closed loop on the conv-kernel path, every per-shape record
    beside."""
    csrc = "state_policy_diffusionmodel_torch/csrc/"
    tpu = "state_policy_diffusionmodel_tpu/models/pallas_ops.py:"
    launches = loop["fp32"]["conv_path"]["launches"]
    on_policy = runs["fp32"]["conv_path"]["kernels_on_policy"]
    entries = []
    for name, k, source, line, recs, calls, key in (
            ("conv3x3", "K3", csrc + "conv3x3.cu", 137, k3, conv_calls(),
             lambda r: (r["H"], r["W"], r["Cin"], r["Cout"])),
            ("gn_act", "K4", csrc + "gn_act.cu", 465, k4, gn_calls(),
             lambda r: (r["H"], r["W"], r["C"], r["variant"])),
            ("double_conv", "K5",
             "state_policy_diffusionmodel_torch/models/cuda_ops.py", 535, k5,
             DC_SHAPES,
             lambda r: (r["H"], r["W"], r["Cin"], r["Cout"], r["residual"]))):
        fwd = per_forward(recs, calls, key)
        fwd_bf16 = per_forward(recs, calls, key, "bfloat16")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"{tpu}{line}", "launches": launches[k],
            "max_abs_err": fwd["max_abs_err"],
            "max_rel_err_on_policy": on_policy[f"{k}_max_rel_err"],
            "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
            "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
            "library_ms": fwd["library_ms"], "bf16": fwd_bf16,
            "per_shape": recs})
        for b in ("bound_ms_9taps", "bound_ms_taps_computed"):
            if b in fwd:
                entries[-1][b] = fwd[b]
    entries[-1]["sources"] = [csrc + "conv3x3.cu", csrc + "gn_act.cu"]
    return entries


# ---------------------------------------------------------------------------
# training: K6, gradients on the card, data, the CLI, step times
# ---------------------------------------------------------------------------

# (H, W, Cin, Cout) of the 31 convs of one r5blend training step whose
# weight gradient K6 computes on SPDM_CONV_BWD=pallas: DoubleConv_0's second
# conv (its first, Cin=1, is off the rule), then both convs of the other 15
TRAIN_CONVS = [(32, 8, 64, 64)] + conv_calls()
# K6 against its plain version, over the largest |dw|: fp32 sums of up to
# 65,536 products in two orders; bf16 inputs the limit of one bf16 ulp
K6_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# gradients of the U-Net on a kernel path against the all-plain path, fp32:
# each tensor's max abs error over its largest |grad|. The attention key
# biases get no gradient in exact arithmetic (softmax ignores a shift shared
# by a row of scores), so both paths return rounding noise there (~1e-10 of
# the largest gradient on an H100); they are held below GRAD_ZERO of the
# largest gradient of all instead
GRAD_TOL, GRAD_ZERO = 1e-4, 1e-6
# amp: a kernel path's relative L2 distance from the fp32 plain gradient may
# exceed the amp plain path's own by at most this factor
AMP_GRAD_FACTOR = 1.5
# the card's data: the PID lane follower (mode middle, 30 speed units) on
# each track of the cached 16-track bank (seeds 100..115), COLLECT_STEPS
# steps; SHORT_STEPS steps each of the other two drivers
DATA_ENVS, COLLECT_STEPS, SHORT_STEPS = 16, 400, 50
DATA_SEEDS = list(range(100, 100 + DATA_ENVS))
# the eval phase: r5blend's EMA weights through cli/evaluate.py's `all` on
# the collected store, DDIM-10 leading
EVAL_ARGS = ["all", "--run_dir", RUN_DIR, "--ema", "--dataset_name",
             "card.zarr", "--window", "70", "--max_windows", "256",
             "--sampler", "ddim", "--num_inference_steps", "10",
             "--ddim_spacing", "leading", "--device", "cuda"]
# the batch sizes K1 takes on the eval path: evaluate.py's --n_runs 5
# (consistency, precision, action consistency), one sample (robustness,
# compare, smoke) and accuracy's 64-window chunks
EVAL_BATCHES = (1, 5, 64)
# the O(1) car_state warm start against the replay warm start, world units
# (tests/test_eval.py's bound for JAX)
WARM_TOL = 5e-3
# r5blend's recipe (artifacts/r5blend_best/hparams.yaml)
RECIPE = ["--batch_size", "256", "--lr", "4e-4", "--lr_schedule", "cosine",
          "--min_lr", "1e-6", "--ema_decay", "0.9995", "--device_data",
          "--no_early_stop", "--no_sample_viz", "--n_epochs", "1"]
TIMED_STEPS, WARMUP_STEPS = 5, 2
# the gradient and timing paths: (CONV_PATH, CONV_BWD)
TRAIN_PATHS = {"default": ("xla9", ""), "conv_bwd": ("xla9", "pallas"),
               "conv_path": ("pallas", ""), "both": ("pallas", "pallas")}


@contextlib.contextmanager
def conv_paths(cuda_ops, conv_path, conv_bwd, attention=None):
    """The conv path and the backward selector set (and the attention core
    replaced, when given) for the block."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(cuda_ops, "CONV_PATH",
                                              conv_path))
        stack.enter_context(mock.patch.object(cuda_ops, "CONV_BWD",
                                              conv_bwd))
        if attention is not None:
            stack.enter_context(mock.patch.object(cuda_ops, "attention_core",
                                                  attention))
        yield


def time_train_steps(policy, params0, twin, seed, amp, device, counts):
    """r5blend training steps at B=N_ENVS with EMA on, from a copy of
    params0: a batch gathered by the device twin and one optimizer step,
    host wall time ending in a synchronize. Returns the median over
    TIMED_STEPS after WARMUP_STEPS, and the launches a step."""
    from state_policy_diffusionmodel_torch.train import loop

    zero_counts, read_counts = counts
    params = copy.deepcopy(params0)
    cfg = loop.TrainConfig(lr=4e-4, batch_size=N_ENVS, ema_decay=0.9995)
    opt = loop.make_optimizer(cfg, params)
    step = loop.make_train_step(policy, params, opt, amp,
                                copy.deepcopy(params), cfg.ema_decay)
    gen = torch.Generator(device=device).manual_seed(seed)
    order = np.random.default_rng(seed).permutation(len(twin))
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            zero_counts()
        idx = np.roll(order, -i * N_ENVS)[:N_ENVS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(twin.batch(idx, image_frames=10), cfg.lr, gen))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n = {k: v / TIMED_STEPS for k, v in read_counts().items()}
    ms = float(np.median(times[WARMUP_STEPS:]))
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise Failed(f"train steps gave losses {losses}")
    return dict(ms=ms, ms_each=times[WARMUP_STEPS:],
                samples_per_s=N_ENVS / ms * 1e3, launches_per_step=n,
                losses=losses,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def k6_bound(B, H, W, cin, cout, dtype, taps):
    """x and g read once, dw (f32) written once; 2*P*taps*Cin*Cout
    operations at the peak rate for the inputs' type."""
    P = B * H * W
    n_bytes = P * (cin + cout) * itemsize(dtype) + 9 * cin * cout * 4
    return bound(n_bytes / HBM_BYTES_PER_S * 1e3,
                 2 * P * taps * cin * cout / PEAK_OPS[dtype] * 1e3)


def check_k6(cuda_ops, device, build):
    """K6 alone at the 17 distinct conv shapes of a training step, fp32 and
    bf16: against its plain version, twice (bit-identical), with its time,
    the plain version's, cuDNN's weight gradient (aten.convolution_backward
    on the channels-last views, dw only; a yardstick, never on the path),
    the bound of the taps the gradient needs (three where W == 1; beside it
    the nine-tap bound and that of the taps the kernel computes), the
    achieved TFLOP/s of the taps needed and the plan (with the ring depth
    the launcher takes); first the ptxas line of each kernel. Returns
    per-shape records and the ptxas rows."""
    ptxas = print_ptxas(build, "conv_dw")
    gen = torch.Generator(device=device).manual_seed(1357)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, cin, cout in dict.fromkeys(TRAIN_CONVS):
            x = torch.randn((N_ENVS, H, W, cin), generator=gen,
                            device=device).to(dtype)
            g = torch.randn((N_ENVS, H, W, cout), generator=gen,
                            device=device).to(dtype)
            key = f"{H}x{W} {cin}->{cout}"
            got = cuda_ops.conv_dw_cuda(x, g)
            again = cuda_ops.conv_dw_cuda(x, g)
            rec = check_kernel("K6", records, key, got,
                               cuda_ops.conv_dw_ref(x, g), K6_TOL, dtype,
                               H=H, W=W, Cin=cin, Cout=cout)
            if not torch.equal(got, again):
                raise Failed(f"K6 {dtype} {key}: two runs differ")
            plan = cuda_ops.conv_dw_plan(N_ENVS, H, W, cin, cout, dtype,
                                         cuda_ops._n_sm(device))
            rec["plan"] = dict(route="mma" if plan.mma else "cuda cores",
                               taps=plan.taps,
                               ring=cuda_ops.conv_dw_ring(plan, H, W),
                               chunks=plan.chunks, blocks=plan.blocks)
            w_cl = torch.empty((cout, cin, 3, 3), device=device,
                               dtype=dtype).contiguous(
                memory_format=torch.channels_last)
            x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            timed(rec, lambda: cuda_ops.conv_dw_cuda(x, g),
                  lambda: cuda_ops.conv_dw_ref(x, g),
                  lambda: torch.ops.aten.convolution_backward(
                      g_cl, x_cl, w_cl, None, [1, 1], [1, 1], [1, 1], False,
                      [0, 0], 1, [False, True, False]), iters=10)
            taps = conv_taps(W)
            rec["bound_ms"], rec["bound_by"] = k6_bound(N_ENVS, H, W, cin,
                                                        cout, dtype, taps)
            rec["bound_ms_9taps"] = k6_bound(N_ENVS, H, W, cin, cout, dtype,
                                             9)[0]
            rec["bound_ms_taps_computed"] = k6_bound(
                N_ENVS, H, W, cin, cout, dtype, plan.taps)[0]
            flops = 2 * N_ENVS * H * W * taps * cin * cout
            rec["tflops"] = flops / rec["ms"] / 1e9
            print(f"  K6 {rec['dtype']:8s} {key:16s}: rel err "
                  f"{rec['max_rel_err']:.2e}, repeat equal  kernel "
                  f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s)  plain "
                  f"{rec['plain_ms']:.4f}  cuDNN {rec['library_ms']:.4f}  "
                  f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}, {taps} "
                  f"taps; 9 taps {rec['bound_ms_9taps']:.4f}, {plan.taps} "
                  f"computed {rec['bound_ms_taps_computed']:.4f})  "
                  f"plan {rec['plan']}", flush=True)
    return records, ptxas


def attention_bwd_ms(cuda_ops, device):
    """K1's backward (`attention_core_bwd`, plain torch as in JAX) at the
    five attention shapes of a training step at B=256, fp32, graph-timed."""
    gen = torch.Generator(device=device).manual_seed(97)
    total = 0.0
    for T, C in ATTN_SHAPES:
        q, k, v, g = (torch.randn((N_ENVS, T, C), generator=gen,
                                  device=device) for _ in range(4))
        total += graph_ms(lambda: cuda_ops.attention_core_bwd(q, k, v, g,
                                                              HEADS), 10)
    return total


def lane_probe(bank, device):
    """The collection's lane-follower drive, stepped here through the
    public env and controller API with what collect_episodes keeps to
    itself read on the way: (actions (B, COLLECT_STEPS, 3), the share of
    steps that found the lane, tile counts after the first step and at
    the end)."""
    from state_policy_diffusionmodel_torch import control
    from state_policy_diffusionmodel_torch.control.drivers import lane_column
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.physics.car import sqrt

    ids = torch.arange(DATA_ENVS, dtype=torch.int32, device=device)
    states, res = vector.reset_batch(bank, track_ids=ids, device=device)
    params = control.lane_follow_params("middle", 30.0, device)
    ctrl = control.lane_follow_init(DATA_ENVS, device)
    found, actions = [], []
    for i in range(COLLECT_STEPS):
        v = res.info.car_velocity
        speed = sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])
        found.append(lane_column(res.augmented, params.mode)[1])
        a, ctrl = control.lane_follow(params, ctrl, res.augmented, speed)
        actions.append(a)
        states, res = vector.step_batch(states, bank, a, track_ids=ids,
                                        device=device)
        if i == 0:
            first = states.tile_count.clone()
    return (torch.stack(actions, 1).cpu().numpy(),
            torch.stack(found).float().mean().item(), first.tolist(),
            states.tile_count.tolist())


def store_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def collect_phase(device, work, counts, smi):
    """The collection path on the card: the lane follower on the 16-track
    bank (K2 each step), timed as it runs, then driven once more by
    lane_probe for what the collection does not return (the found share,
    the tile counts), its actions equal to the collected ones; the centre
    follower and the sinusoidal weaver for SHORT_STEPS steps each; the lane
    follower's episodes written through the default ZarrReplayBuffer (blosc
    zstd-5 with bitshuffle) into work/card.zarr and read back through
    load_zarr, and written once more as zlib level 1 for its size and its
    read time. Returns (the store's path, readings)."""
    from state_policy_diffusionmodel_torch.data import (
        ZarrReplayBuffer, collect_episodes, load_zarr,
    )
    from state_policy_diffusionmodel_torch.track import load_or_build_bank

    zero_counts, read_counts = counts
    bank = load_or_build_bank(DATA_ENVS, bake=True, device=device)
    torch.cuda.synchronize()
    # the collection path: counts to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    eps = collect_episodes(DATA_SEEDS, driver="lane_follow", mode="middle",
                           target_velocity=30.0, n_steps=COLLECT_STEPS,
                           geoms=bank, return_states=True, device=device)
    secs = time.perf_counter() - t0
    n = read_counts()
    actions, share, first, last = lane_probe(bank, device)
    steps_per_s = DATA_ENVS * COLLECT_STEPS / secs
    print(f"  lane_follow (middle, 30): {DATA_ENVS} envs x {COLLECT_STEPS} "
          f"steps in {secs:.2f} s = {steps_per_s:.1f} env steps/s; launches "
          f"{n}; lane found on {share:.4f} of the steps; tiles after the "
          f"first step {first}, at the end {last}", flush=True)
    if n != {"K1": 0, "K2": COLLECT_STEPS + 1, "K3": 0, "K4": 0, "K5": 0,
             "K6": 0}:
        raise Failed(f"collection launched {n}: expected one K2 launch a "
                     f"step and the reset's ({COLLECT_STEPS + 1}), nothing "
                     "else")
    if not np.array_equal(actions, np.stack([ep["action"] for ep in eps])):
        raise Failed("the probe's lane-follower actions differ from the "
                     "collected ones")
    if not all(b > a for a, b in zip(first, last)):
        raise Failed(f"an episode's tile count did not rise: {first} -> "
                     f"{last}")
    bad = [(i, k) for i, ep in enumerate(eps) for k, v in ep.items()
           if not np.isfinite(v).all()]
    if bad:
        raise Failed(f"non-finite collected records {bad}")
    out = dict(seconds=secs, steps=COLLECT_STEPS, envs=DATA_ENVS,
               env_steps_per_s=steps_per_s, launches=n, lane_found=share,
               tiles_first=first, tiles_last=last)

    for driver in ("center_follow", "sinusoidal"):
        t0 = time.perf_counter()
        short = collect_episodes(DATA_SEEDS, driver=driver,
                                 n_steps=SHORT_STEPS, geoms=bank,
                                 device=device)
        dt = time.perf_counter() - t0
        a = np.stack([ep["action"] for ep in short])
        print(f"  {driver}: {DATA_ENVS} envs x {SHORT_STEPS} steps in "
              f"{dt:.2f} s, actions {a.shape}, mean |a| "
              f"{np.abs(a).mean(axis=(0, 1)).round(4).tolist()}", flush=True)
        if a.shape != (DATA_ENVS, SHORT_STEPS, 3) or \
                not np.isfinite(a).all():
            raise Failed(f"{driver}: actions {a.shape}, or not finite")
        out[driver] = dict(seconds=dt, steps=SHORT_STEPS)

    t0 = time.perf_counter()
    store = os.path.join(work, "card.zarr")
    z = ZarrReplayBuffer.create_empty_zarr(store)
    for ep in eps:
        z.add_episode(ep)
    z.meta["track_seed"] = np.asarray(DATA_SEEDS, np.int64)
    z.save_meta()
    write_s = time.perf_counter() - t0
    with open(os.path.join(store, "data", "img", ".zarray")) as f:
        comp = json.load(f)["compressor"]
    if comp != {"blocksize": 0, "clevel": 5, "cname": "zstd", "id": "blosc",
                "shuffle": 2}:
        raise Failed(f"the default store's img is written with {comp}, not "
                     "the JAX store's blosc zstd-5 with bitshuffle")
    t0 = time.perf_counter()
    back = load_zarr(store)
    read_s = time.perf_counter() - t0
    for k in eps[0]:
        if not np.array_equal(back.data[k],
                              np.concatenate([ep[k] for ep in eps])):
            raise Failed(f"data/{k} read back differs from the episodes")
    if not (np.array_equal(back.episode_ends, np.arange(1, DATA_ENVS + 1)
                           * COLLECT_STEPS)
            and np.array_equal(back.meta["track_seed"], DATA_SEEDS)):
        raise Failed(f"episode ends {back.episode_ends} or track seeds "
                     f"{back.meta.get('track_seed')} read back wrong")
    raw = sum(ep[k].nbytes for ep in eps for k in ep)
    disk = store_bytes(store)
    zl = os.path.join(work, "card_zlib.zarr")
    t0 = time.perf_counter()
    zz = ZarrReplayBuffer.create_empty_zarr(
        zl, compressors={k: {"id": "zlib", "level": 1} for k in eps[0]})
    for ep in eps:
        zz.add_episode(ep)
    zlib_s = time.perf_counter() - t0
    zlib_disk = store_bytes(zl)
    # the read side of both formats, as the trainer's load_zarr reads them:
    # zlib-1, then the default store a second time (both warm in the page
    # cache, just written)
    t0 = time.perf_counter()
    zback = load_zarr(zl)
    zlib_read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_zarr(store)
    read2_s = time.perf_counter() - t0
    shutil.rmtree(zl)
    for k in back.data:
        if not np.array_equal(zback.data[k], back.data[k]):
            raise Failed(f"data/{k} of the zlib-1 store reads back unlike "
                         "the default store's")
    print(f"  {z.n_episodes} episodes, {z.n_steps} frames written through "
          f"ZarrReplayBuffer (blosc zstd-5, bitshuffle) in {write_s:.2f} s "
          f"= {raw / 1e6 / write_s:.1f} MB/s (host) and read back through "
          f"load_zarr in {read_s:.2f} s: every array equal; keys "
          f"{sorted(back.data)}; {raw} bytes -> {disk} on disk "
          f"({raw / disk:.3f}x); the same episodes as zlib level 1: "
          f"{zlib_disk} bytes ({zlib_disk / disk:.3f}x the default's) in "
          f"{zlib_s:.2f} s; card: {smi}", flush=True)
    print(f"  load_zarr (warm page cache): zlib level 1 {zlib_read_s:.2f} s "
          f"= {raw / 1e6 / zlib_read_s:.1f} MB/s, every array equal to the "
          f"default's; the default (blosc zstd-5, bitshuffle) again "
          f"{read2_s:.2f} s = {raw / 1e6 / read2_s:.1f} MB/s (host); card: "
          f"{smi}", flush=True)
    out.update(write_seconds=write_s, read_seconds=read_s, raw_bytes=raw,
               disk_bytes=disk, write_mb_per_s=raw / 1e6 / write_s,
               zlib1_bytes=zlib_disk, zlib1_seconds=zlib_s,
               zlib1_read_seconds=zlib_read_s, read2_seconds=read2_s,
               card=smi)
    return store, out


# the codecs step: the zarr compressors the JAX package's store takes
# beyond its presets, each on every array of the first CODEC_EPISODES
# collected episodes
CODEC_EPISODES = 4
CODEC_SPECS = [
    ("gzip 5", {"id": "gzip", "level": 5}),
    ("bz2 1", {"id": "bz2", "level": 1}),
    ("zstd 3", {"id": "zstd", "level": 3}),
    ("blosc blosclz-5, byte shuffle",
     {"id": "blosc", "cname": "blosclz", "clevel": 5, "shuffle": 1}),
    ("blosc snappy-5, byte shuffle",
     {"id": "blosc", "cname": "snappy", "clevel": 5, "shuffle": 1}),
    ("blosc lz4-5, auto shuffle, blocksize 65,536",
     {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": -1,
      "blocksize": 65536}),
]


def codecs_phase(store, work, smi):
    """The first CODEC_EPISODES episodes of the collected store written
    through save_to_path with each of CODEC_SPECS (every array) and read
    back through load_zarr, equal; each spec's bytes, write and read
    seconds (host). Returns one record a spec."""
    from state_policy_diffusionmodel_torch.data import (
        ReplayBuffer, ZarrReplayBuffer, load_zarr,
    )
    from state_policy_diffusionmodel_torch.data.replay_buffer import (
        _zarray_compressor,
    )

    z = ZarrReplayBuffer(store)
    buf = ReplayBuffer()
    for i in range(CODEC_EPISODES):
        buf.add_episode(z.get_episode(i))
    buf.meta["track_seed"] = np.asarray(z.meta["track_seed"][:CODEC_EPISODES])
    raw = sum(v.nbytes for v in buf.data.values())
    keys = [*buf.data, "episode_ends", *buf.meta]
    out = []
    for name, spec in CODEC_SPECS:
        path = os.path.join(work, "codec.zarr")
        t0 = time.perf_counter()
        buf.save_to_path(path, compressors={k: spec for k in keys})
        write_s = time.perf_counter() - t0
        disk = store_bytes(path)
        t0 = time.perf_counter()
        back = load_zarr(path)
        read_s = time.perf_counter() - t0
        with open(os.path.join(path, "data", "img", ".zarray")) as f:
            stated = json.load(f)["compressor"]
        shutil.rmtree(path)
        if stated != _zarray_compressor(spec):
            raise Failed(f"{name}: data/img's .zarray states {stated}")
        for k, v in buf.data.items():
            if not (back.data[k].dtype == v.dtype
                    and np.array_equal(back.data[k], v)):
                raise Failed(f"{name}: data/{k} reads back unlike the "
                             "episodes")
        if not (np.array_equal(back.episode_ends, buf.episode_ends)
                and np.array_equal(back.meta["track_seed"],
                                   buf.meta["track_seed"])):
            raise Failed(f"{name}: episode ends or track seeds read back "
                         "wrong")
        print(f"  {name}: {buf.n_episodes} episodes, {buf.n_steps} frames, "
              f"{raw} bytes -> {disk} on disk ({raw / disk:.3f}x); write "
              f"{write_s:.2f} s = {raw / 1e6 / write_s:.1f} MB/s, load_zarr "
              f"{read_s:.2f} s = {raw / 1e6 / read_s:.1f} MB/s (host), every "
              f"array equal; card: {smi}", flush=True)
        out.append(dict(spec=name, compressor=stated, frames=buf.n_steps,
                        raw_bytes=raw, disk_bytes=disk, write_seconds=write_s,
                        write_mb_per_s=raw / 1e6 / write_s,
                        read_seconds=read_s, read_mb_per_s=raw / 1e6 / read_s,
                        equal=True, card=smi))
    return out


def check_k1_eval_batches(cuda_ops, device):
    """K1 at the shapes the eval path gives it: r5blend's five (T, C) at
    each of EVAL_BATCHES, fp32, against its plain version within K1_TOL,
    twice (bit-identical). Returns the worst error."""
    gen = torch.Generator(device=device).manual_seed(4321)
    worst = 0.0
    for B in EVAL_BATCHES:
        for T, C in ATTN_SHAPES:
            q, k, v = (torch.randn((B, T, C), generator=gen, device=device)
                       for _ in range(3))
            got = cuda_ops.attention_core_cuda(q, k, v, HEADS)
            again = cuda_ops.attention_core_cuda(q, k, v, HEADS)
            want = cuda_ops.attention_core_ref(q, k, v, HEADS)
            err = (got - want).abs().max().item()
            tol = K1_TOL[torch.float32]
            if not err <= tol:
                raise Failed(f"K1 float32 B={B} T={T} C={C}: max abs err "
                             f"{err} > {tol}")
            if not torch.equal(got, again):
                raise Failed(f"K1 float32 B={B} T={T} C={C}: two runs "
                             "differ")
            worst = max(worst, err)
    print(f"  K1 float32 at the eval's batch sizes {EVAL_BATCHES} x "
          f"r5blend's {len(ATTN_SHAPES)} shapes: max abs err {worst:.3e} "
          f"(tol {K1_TOL[torch.float32]:.1e}), repeats equal", flush=True)
    return worst


def eval_phase(device, work, counts, cuda_ops):
    """r5blend (EMA) through cli/evaluate.py's `all` on the collected store,
    fp32: each eval's summary and seconds, the K1 launches (and no K2: the
    replays do not render), accuracy windows/s, every returned array
    finite; K1 held against its plain version at the eval's batch sizes;
    then the O(1) car_state warm start against the replay warm start at
    window 70."""
    from state_policy_diffusionmodel_torch import eval as E
    from state_policy_diffusionmodel_torch.cli import evaluate
    from state_policy_diffusionmodel_torch.data import WindowDataset
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    torch.cuda.synchronize()
    # the eval path: counts to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    res = evaluate.main(EVAL_ARGS + ["--dataset_dir", work])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = read_counts()
    seconds = {name: r["seconds"] for name, r in res.items()}
    acc = res["accuracy"]
    wps = len(acc["per_window_error"]) / seconds["accuracy"]
    print(f"  evaluate all in {secs:.2f} s; launches {n}; seconds an eval "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }; accuracy "
          f"{len(acc['per_window_error'])} windows at {wps:.1f} windows/s, "
          f"overall {acc['overall']:.4f}, action overall "
          f"{acc['action_overall']:.4f}", flush=True)
    if not n["K1"] or any(n[k] for k in ("K2", "K3", "K4", "K5", "K6")):
        raise Failed(f"evaluate launched {n}: expected K1 and nothing else")
    if len(acc["per_window_error"]) != 256:
        raise Failed(f"accuracy swept {len(acc['per_window_error'])} "
                     "windows, not 256")

    def arrays(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from arrays(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from arrays(v)
        elif isinstance(x, (np.ndarray, float, np.floating)):
            yield np.asarray(x)

    bad = [name for name, r in res.items()
           if not all(np.isfinite(a).all() for a in arrays(r))]
    if bad:
        raise Failed(f"evals {bad} returned non-finite values")
    k1_err = check_k1_eval_batches(cuda_ops, device)

    policy, params, stats = load_run(RUN_DIR, device, ema=True)
    cfg = policy.config
    ds = WindowDataset(os.path.join(work, "card.zarr"), cfg.obs_horizon,
                       cfg.pred_horizon, cfg.step_size, stats=stats)
    plain = copy.copy(ds)
    plain.car_state = None
    warm = {}
    for tag, d in (("o1", ds), ("replay", plain)):
        ctx = E.EvalContext(policy=policy, params=params, dataset=d)
        start = ctx.window(70)[2]
        t0 = time.perf_counter()
        _, st, _, n_warm = ctx.warmed_state(start)
        warm[tag] = (st, time.perf_counter() - t0, n_warm)
    gap = max((warm["o1"][0].car.pos - warm["replay"][0].car.pos).abs().max()
              .item(), (warm["o1"][0].car.vel - warm["replay"][0].car.vel)
              .abs().max().item())
    print(f"  window 70 warm start ({warm['o1'][2]} frames): O(1) car_state "
          f"restore in {warm['o1'][1]:.3f} s, replay in "
          f"{warm['replay'][1]:.3f} s; position and velocity apart by "
          f"{gap:.3e} (tol {WARM_TOL})", flush=True)
    if not gap <= WARM_TOL:
        raise Failed(f"the O(1) warm start is {gap} from the replay's")
    return dict(seconds=secs, eval_seconds=seconds, launches=n,
                accuracy_windows_per_s=wps, accuracy_windows=256,
                overall=acc["overall"], action_overall=acc["action_overall"],
                warm_start_gap=gap, k1_eval_batches_err=k1_err)


def unet_grads(policy, params, batch, t, noise, amp=False,
               trained=("unet",)):
    """(loss, {module.parameter: grad}) for one batch at fixed t and noise,
    with amp as the train step computes it (`amp_params`): the U-Net's
    gradients, or those of every module in `trained` (the encoder too
    where it trains, as r4rn's)."""
    from state_policy_diffusionmodel_torch.train import loop

    for name in trained:
        params[name].zero_grad(set_to_none=True)
    mods = params
    if amp:
        batch = {k: v.to(torch.bfloat16) for k, v in batch.items()}
        mods = loop.amp_params(params)
    loss = policy.loss(mods, batch, t=t, noise=noise)
    loss.backward()
    return loss.detach(), {f"{top}.{n}": p.grad.detach().clone()
                           for top in trained
                           for n, p in params[top].named_parameters()}


def grad_gap(got, want):
    """Per tensor, max abs error over its largest |grad|; the attention key
    biases (zero in exact arithmetic) apart. Returns (worst relative error,
    the largest key-bias gradient over the top gradient, their names)."""
    top = max(g.abs().max() for g in want.values())
    worst, worst_zero, zeros = 0.0, 0.0, []
    for n, w in want.items():
        err = (got[n] - w).abs().max()
        if n.endswith("MultiHeadDotProductAttention_0.key.bias"):
            zeros.append(n)
            worst_zero = max(worst_zero, (got[n].abs().max() / top).item())
        else:
            worst = max(worst, (err / w.abs().max()).item())
    return worst, worst_zero, zeros


def floored_grad_gap(got, want):
    """grad_gap for a net whose gradients reach the rounding floor: each
    tensor's max abs error over the larger of its largest |grad| and
    GRAD_ZERO of the largest gradient of all (r4rn's bottleneck blocks take
    ~1e-9 of the largest gradient, a small difference of large terms, so
    their own relative error says nothing of the kernels), the key biases
    apart as in grad_gap. Returns the worst, its tensor, the tensors held
    at the floor, and the worst and its tensor without the floor."""
    top = max(g.abs().max() for g in want.values())
    rows = []
    for n, w in want.items():
        if n.endswith("MultiHeadDotProductAttention_0.key.bias"):
            continue
        err, own = (got[n] - w).abs().max(), w.abs().max()
        rows.append(((err / torch.maximum(own, GRAD_ZERO * top)).item(),
                     (err / own).item(), (own < GRAD_ZERO * top).item(), n))
    worst = max(rows)
    own_worst = max(rows, key=lambda r: r[1])
    return dict(max_rel_err=worst[0], worst_tensor=worst[3],
                floored_tensors=sum(r[2] for r in rows),
                max_rel_err_own=own_worst[1],
                worst_tensor_own=own_worst[3])


def rel_l2(got, want):
    num = sum(((got[n] - w) ** 2).sum() for n, w in want.items())
    den = sum((w ** 2).sum() for w in want.values())
    return (num / den).sqrt().item()


def train_phases(args, device, cuda_ops, policy, params, stats, counts,
                 work):
    """The training slice's phases on the PID-collected store work/card.zarr:
    its windows, gradients on the card on every kernel path, one epoch
    through the CLI, a closed loop served from the run it wrote, and
    train-step times. The run is written under `work`."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.cli import train_policy
    from state_policy_diffusionmodel_torch.data import (
        DeviceWindowDataset, WindowDataset,
    )
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    out = {}
    with phase("windows of the collected data"):
        t0 = time.perf_counter()
        ds = WindowDataset(os.path.join(work, "card.zarr"), 10, 30, 5)
        io_s = time.perf_counter() - t0
        want = DATA_ENVS * (COLLECT_STEPS - 40 * 5 + 1)
        print(f"  WindowDataset over the lane follower's {DATA_ENVS} "
              f"episodes of {COLLECT_STEPS} frames: {len(ds)} windows "
              f"(want {want}), read in {io_s:.2f} s")
        if len(ds) != want:
            raise Failed(f"{len(ds)} windows from the card's data")
        out["data"] = dict(io_seconds=io_s, windows=len(ds),
                           episodes=DATA_ENVS)

    with phase("gradients on the card"):
        twin = DeviceWindowDataset(ds, device)
        idx = np.random.default_rng(args.seed).permutation(
            len(ds))[:N_ENVS]
        batch = twin.batch(idx, image_frames=10)
        gen = torch.Generator(device=device).manual_seed(args.seed + 3)
        t = torch.randint(0, 1000, (N_ENVS,), generator=gen,
                          device=device)
        noise = torch.randn((N_ENVS, 31, 5), generator=gen,
                            device=device)
        plain_attn = lambda q, k, v, num_heads=1: \
            cuda_ops.AttentionCore.apply(cuda_ops.attention_core_ref,
                                         num_heads, q, k, v)
        ref = {}
        with conv_paths(cuda_ops, "xla9", "", plain_attn):
            for amp in (False, True):
                zero_counts()
                ref[amp] = unet_grads(policy, params, batch, t, noise,
                                      amp)
                if any(read_counts().values()):
                    raise Failed(f"the plain path launched "
                                 f"{read_counts()}")
        plain_gap = rel_l2(ref[True][1], ref[False][1])
        print(f"  all-plain path: loss fp32 {ref[False][0].item():.6f}, "
              f"amp {ref[True][0].item():.6f}; amp gradient vs fp32: "
              f"relative L2 {plain_gap:.3e}")
        grads = {}
        for name, (cp, cb) in TRAIN_PATHS.items():
            grads[name] = {}
            want = {"K1": 5, "K2": 0, "K3": 30 * (cp == "pallas"),
                    "K4": 30 * (cp == "pallas"),
                    "K5": 15 * (cp == "pallas"),
                    "K6": 31 * (cb == "pallas")}
            for amp in (False, True):
                tag = "amp" if amp else "fp32"
                with conv_paths(cuda_ops, cp, cb):
                    # one loss and backward: counts to 0, read after
                    zero_counts()
                    loss, g = unet_grads(policy, params, batch, t,
                                         noise, amp)
                    torch.cuda.synchronize()
                    n = read_counts()
                rec = dict(loss=loss.item(), launches=n)
                gap = rel_l2(g, ref[False][1])
                rec["rel_l2_vs_fp32_plain"] = gap
                if amp:
                    rec["limit"] = AMP_GRAD_FACTOR * plain_gap
                    ok = gap <= rec["limit"]
                else:
                    worst, worst_zero, zeros = grad_gap(g, ref[False][1])
                    rec.update(max_rel_err=worst,
                               zero_tensors_max=worst_zero,
                               zero_tensors=len(zeros))
                    ok = worst <= GRAD_TOL and worst_zero <= GRAD_ZERO
                grads[name][tag] = rec
                print(f"  {name:9s} {tag}: {fmt(rec)}", flush=True)
                if n != want:
                    raise Failed(f"gradients, {name} {tag}: launches "
                                 f"{n}, expected {want}")
                if not (ok and np.isfinite(rec["loss"])):
                    raise Failed(f"gradients, {name} {tag}: {rec}")
        params["unet"].zero_grad(set_to_none=True)
        out["gradients"] = grads

    run = os.path.join(work, "runs", "r5blend_recipe")
    with phase("training through the CLI"):
        # the main path: counts to 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        res = train_policy.main([
            "--dataset_dir", work, "--dataset_name", "card.zarr",
            "--out_dir", os.path.join(work, "runs"),
            "--version", "r5blend_recipe", "--encoder_ckpt", RUN_DIR,
            "--seed", "42"] + RECIPE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = read_counts()
        with open(os.path.join(run, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e[k] for e in events for k in ("loss", "val_loss",
                                                 "train_loss") if k in e]
        missing = [p for p in ("checkpoints/epoch=0/params.npz",
                               "checkpoints_ema/epoch=0/params.npz",
                               "STATS.pkl", "hparams.yaml",
                               "metrics.jsonl",
                               "trainer_state/opt/params.npz")
                   if not os.path.exists(os.path.join(run, p))]
        epoch = next(e for e in events if e["event"] == "epoch")
        print(f"  one epoch, r5blend's recipe, {res['step']} steps of "
              f"{N_ENVS} in {secs:.2f} s (the epoch {epoch['seconds']:.2f}"
              f" s, {epoch['samples_per_sec']:.1f} samples/s); train "
              f"loss {res['history']['train_loss']}, val "
              f"{res['history']['val_loss']}; launches {n}")
        if missing or not losses or not all(np.isfinite(losses)):
            raise Failed(f"CLI training: missing {missing}, losses "
                         f"{losses}")
        if not n["K1"] or any(n[k] for k in ("K2", "K3", "K4", "K5",
                                             "K6")):
            raise Failed(f"CLI training on the default paths launched "
                         f"{n}")
        out["cli"] = dict(seconds=secs, steps=res["step"],
                          history=res["history"], launches=n,
                          epoch_seconds=epoch["seconds"],
                          samples_per_s=epoch["samples_per_sec"])

    with phase("serve the trained run"):
        tpol, tparams, tstats = load_run(run, device, ema=True)
        bank = load_or_build_bank(LOOP_TRACKS, bake=True, device=device)
        ids = torch.arange(DATA_ENVS, dtype=torch.int32,
                           device=device) % LOOP_TRACKS
        fn = diffusion.make_ring_policy(tpol, tstats, sampler="ddim",
                                        num_inference_steps=10,
                                        seed=args.seed)
        _, _, served = vector.rollout_policy(
            bank, diffusion.env_policy(fn, tparams),
            diffusion.init_ring_carry(tpol, DATA_ENVS), 10,
            auto_reset=False, track_ids=ids, device=device)
        a = served.actions
        print(f"  the EMA checkpoint serves {DATA_ENVS} envs x 10 "
              f"frames: actions {tuple(a.shape)}, mean |a| "
              f"{a.abs().mean().item():.4f}")
        if tuple(a.shape) != (10, DATA_ENVS, 3) or not bool(
                torch.isfinite(a).all()):
            raise Failed(f"the trained run serves actions "
                         f"{tuple(a.shape)}, or not finite")
        out["served"] = dict(frames=10, envs=DATA_ENVS,
                             mean_abs_action=a.abs().mean().item())

    with phase("train-step timing"):
        steps = {}
        for name, (cp, cb) in TRAIN_PATHS.items():
            steps[name] = {}
            for amp in (False, True):
                tag = "amp" if amp else "fp32"
                with conv_paths(cuda_ops, cp, cb):
                    rec = time_train_steps(policy, params, twin,
                                           args.seed, amp, device,
                                           counts)
                steps[name][tag] = rec
                print(f"  {name:9s} {tag}: {rec['ms']:.2f} ms a step "
                      f"(median of {TIMED_STEPS}: "
                      f"{[round(v, 2) for v in rec['ms_each']]}), "
                      f"{rec['samples_per_s']:.1f} samples/s, peak "
                      f"{rec['peak_gib']:.2f} GiB; launches a step "
                      f"{rec['launches_per_step']}", flush=True)
        out["step_ms"] = steps
    return out


# ---------------------------------------------------------------------------
# the other nets: UNetSimple on the conv path, r4rn_best (ResNet18GN) served
# and trained, the conv autoencoder
# ---------------------------------------------------------------------------

def unet_simple_phase(cuda_ops, device, seed, counts):
    """One UNetSimple forward (width 16, a 1,350-wide cond, flax's
    initializers from a seeded generator, B=256) on the conv-kernel path:
    exactly 24 K3, 24 K4 and 12 K5 launches; every DoubleConv held against
    its plain version on the forward's own activations (ShadowDoubleConv),
    fp32 and bf16, its shapes SIMPLE_DC_SHAPES; DDIM-10 samples on the
    default path against the conv-kernel path, fp32, within
    SIMPLE_CHAIN_TOL; the forward's time on both paths."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.diffusion.policy import (
        cast_params, init_module_,
    )
    from state_policy_diffusionmodel_torch.models import build_model

    zero_counts, read_counts = counts
    cfg = diffusion.PolicyConfig(model="UNet")
    cond_dim = cfg.obs_horizon * cfg.observation_dim
    unet = init_module_(build_model("UNet", cond_dim, time_dim=cfg.time_dim),
                        torch.Generator().manual_seed(seed)).to(device).eval()
    if (unet.width, cond_dim) != (16, 1350):
        raise Failed(f"UNetSimple of width {unet.width}, cond {cond_dim}")
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    x = torch.randn((N_ENVS, 31, 5, 1), generator=gen, device=device)
    t = torch.randint(0, 1000, (N_ENVS,), generator=gen, device=device)
    cond = torch.randn((N_ENVS, cond_dim), generator=gen, device=device)
    bf16 = cast_params({"unet": unet}, torch.bfloat16)["unet"]
    conv_path = lambda: mock.patch.object(cuda_ops, "CONV_PATH", "pallas")
    want = {"K1": 0, "K2": 0, "K3": 24, "K4": 24, "K5": 12, "K6": 0}
    out = {}
    with torch.no_grad():
        for net, dtype in ((unet, torch.float32), (bf16, torch.bfloat16)):
            tag = "amp" if dtype == torch.bfloat16 else "fp32"
            args = (x.to(dtype), t, cond.to(dtype))
            with conv_path():
                net(*args)                                    # warm-up
                torch.cuda.synchronize()
                # the conv-kernel path: counts to 0 just before, read after
                zero_counts()
                y = net(*args)
                torch.cuda.synchronize()
                n = read_counts()
                shadow = ShadowDoubleConv(cuda_ops)
                with mock.patch.object(cuda_ops, "double_conv", shadow):
                    y_plain = net(*args)
                kernel_ms = cuda_ms(lambda: net(*args), 10)
            plain_ms = cuda_ms(lambda: net(*args), 10)
            on_net = shadow.summary()
            rec = dict(launches=n, kernels_on_net=on_net,
                       vs_plain_rel=rel_err(y, y_plain)[1].item(),
                       forward_ms=kernel_ms, default_forward_ms=plain_ms)
            out[tag] = rec
            print(f"  UNetSimple {tag}, B={N_ENVS}: launches {n}; kernels "
                  f"vs plain on its activations: {fmt(on_net)}; output vs "
                  f"the plain path {rec['vs_plain_rel']:.3e} of its largest;"
                  f" forward {kernel_ms:.3f} ms on the conv kernels, "
                  f"{plain_ms:.3f} ms on the default path", flush=True)
            if n != want:
                raise Failed(f"UNetSimple {tag}: launches {n}, expected "
                             f"{want}")
            if shadow.shapes != set(SIMPLE_DC_SHAPES) or shadow.calls != 12:
                raise Failed(f"UNetSimple {tag}: DoubleConvs "
                             f"{sorted(shadow.shapes)} x {shadow.calls} are "
                             "not SIMPLE_DC_SHAPES x 12")
            for k, tol in (("K3", CONV_TOL), ("K4", CONV_TOL),
                           ("K5", DC_TOL)):
                if not on_net[f"{k}_max_rel_err"] <= tol[dtype]:
                    raise Failed(f"UNetSimple {tag}: {k} differs from its "
                                 f"plain version on the net's activations "
                                 f"by {on_net[f'{k}_max_rel_err']} > "
                                 f"{tol[dtype]}")
    # DDIM-10 from one x_T on both conv paths, fp32
    policy = diffusion.DiffusionPolicy(cfg, device)
    window = {k: torch.randn((N_ENVS, 10, d), generator=gen, device=device)
              for k, d in (("position", 2), ("velocity", 2), ("action", 3),
                           ("image_features", 128))}
    x_T = policy.init_noise(N_ENVS, torch.Generator().manual_seed(seed))
    sample = lambda: policy.sample({"unet": unet}, window, sampler="ddim",
                                   num_inference_steps=10, init_noise=x_T)
    a_default = sample()
    with conv_path():
        a_conv = sample()
    d = (a_conv - a_default).abs().max().item()
    out["ddim10_conv_vs_default_max"] = d
    print(f"  UNetSimple DDIM-10, {N_ENVS} samples, fp32: conv kernels vs "
          f"default path max |diff| {d:.3e} (tol {SIMPLE_CHAIN_TOL})")
    if not (d <= SIMPLE_CHAIN_TOL and bool(torch.isfinite(a_conv).all())):
        raise Failed(f"UNetSimple DDIM-10 on the conv kernels differs from "
                     f"the default path by {d}")
    return out


def r4rn_serve_phase(args, cuda_ops, device, counts):
    """r4rn_best (UNetFiLM width 64 with a trained ResNet18GN encoder,
    epoch-107 EMA) through load_run: the observation-fed ring policy on
    the golden frames at 256 envs x 50 frames, fp32, exactly 500 K1, its
    actions within ACTION_TOL of the plain attention path's and K1 within
    K1_REL_TOL of its plain version on the policy's activations; then the
    closed loop on the 4-track bank, 50 frames in fp32 and amp on both conv
    paths: exactly 500 K1 and 51 K2 (and 3,000 K3, 3,000 K4, 1,500 K5 on
    the conv-kernel path), frames/s; the ResNet's ms on one 256-frame
    batch."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    policy, params, stats = load_run(R4RN_DIR, device, ema=True)
    enc = params["encoder"]
    kinds = (type(params["unet"]).__name__, type(enc).__name__,
             params["unet"].width, policy.config.observation_dim)
    n_enc = sum(p.numel() for p in enc.parameters())
    print(f"  r4rn_best: {kinds}, encoder {n_enc} parameters")
    if kinds != ("UNetFiLM", "ResNet18GN", 64, 519):
        raise Failed(f"r4rn_best loaded as {kinds}")
    out = dict(encoder_parameters=n_enc)
    denoises = N_FRAMES // policy.config.step_size
    k1_want = 5 * 10 * denoises

    stream = observation_stream(stats, args.seed, device)
    fn = diffusion.make_ring_policy(policy, stats, sampler="ddim",
                                    num_inference_steps=10, seed=args.seed)
    rollout(fn, params, diffusion.init_ring_carry(policy, N_ENVS), stream, 5)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    a, _ = rollout(fn, params, diffusion.init_ring_carry(policy, N_ENVS),
                   stream, N_FRAMES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = read_counts()
    shadow = ShadowAttention(cuda_ops)
    with mock.patch.object(cuda_ops, "attention_core", shadow):
        a_plain, _ = rollout(fn, params,
                             diffusion.init_ring_carry(policy, N_ENVS),
                             stream, N_FRAMES)
    k1_real = shadow.summary()
    sp = spread(a, a_plain)
    out["observation_fed"] = dict(seconds=secs, fps=N_ENVS * N_FRAMES / secs,
                                  launches=n, k1_on_policy=k1_real,
                                  vs_plain=sp)
    print(f"  observation-fed, fp32: {N_ENVS * N_FRAMES} frames in "
          f"{secs:.3f} s = {N_ENVS * N_FRAMES / secs:.1f} frames/s, launches "
          f"{n}; K1 vs plain on the policy: {fmt(k1_real)}; actions vs the "
          f"plain attention path: {fmt(sp)}", flush=True)
    if n["K1"] != k1_want or any(n[k] for k in ("K2", "K3", "K4", "K5")):
        raise Failed(f"r4rn observation-fed: launches {n}, expected "
                     f"{k1_want} K1 and nothing else")
    if not (k1_real["max_rel_err"] <= K1_REL_TOL[torch.float32]
            and sp["max"] <= ACTION_TOL and bool(torch.isfinite(a).all())):
        raise Failed(f"r4rn observation-fed: K1 {k1_real}, actions {sp}")

    bank = load_or_build_bank(LOOP_TRACKS, bake=True, device=device)
    ids = torch.arange(N_ENVS, dtype=torch.int32, device=device) \
        % LOOP_TRACKS

    def drive(amp, n_frames):
        fn = diffusion.make_ring_policy(
            policy, stats, sampler="ddim", num_inference_steps=10, amp=amp,
            seed=args.seed)
        return vector.rollout_policy(
            bank, diffusion.env_policy(fn, params),
            diffusion.init_ring_carry(policy, N_ENVS), n_frames,
            auto_reset=False, track_ids=ids, device=device)

    out["closed_loop"] = {}
    for path in ("xla9", "pallas"):
        for amp in (False, True):
            tag = ("amp" if amp else "fp32") + (
                ", conv kernels" if path == "pallas" else "")
            want = {"K1": k1_want, "K2": N_FRAMES + 1, "K6": 0,
                    **{k: (v * denoises if path == "pallas" else 0)
                       for k, v in (("K3", 300), ("K4", 300), ("K5", 150))}}
            with mock.patch.object(cuda_ops, "CONV_PATH", path):
                drive(amp, 5)                                 # warm-up
                torch.cuda.synchronize()
                # the path: counts to 0 just before, read just after
                zero_counts()
                t0 = time.perf_counter()
                states, _, res = drive(amp, N_FRAMES)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n = read_counts()
            acts = res.actions
            rec = dict(seconds=secs, fps=N_ENVS * N_FRAMES / secs,
                       launches=n,
                       tiles=states.tile_count.float().mean().item())
            out["closed_loop"][tag] = rec
            print(f"  closed loop {tag}: {N_ENVS} envs x {N_FRAMES} frames "
                  f"on the {LOOP_TRACKS}-track bank in {secs:.3f} s = "
                  f"{rec['fps']:.1f} frames/s; launches {n}", flush=True)
            if n != want:
                raise Failed(f"r4rn closed loop {tag}: launches {n}, "
                             f"expected {want}")
            if tuple(acts.shape) != (N_FRAMES, N_ENVS, 3) or not bool(
                    torch.isfinite(acts).all()):
                raise Failed(f"r4rn closed loop {tag}: actions "
                             f"{tuple(acts.shape)}, or not finite")

    frames = torch.rand((N_ENVS, 96, 96, 3), generator=torch.Generator(
        device=device).manual_seed(args.seed), device=device)
    enc_bf16 = diffusion.policy.cast_params({"e": enc}, torch.bfloat16)["e"]
    with torch.no_grad():
        out["resnet_ms"] = dict(
            fp32=cuda_ms(lambda: enc(frames), 10),
            bf16=cuda_ms(lambda: enc_bf16(frames.bfloat16()), 10))
    print(f"  ResNet18GN on one {N_ENVS}-frame batch: "
          f"{out['resnet_ms']['fp32']:.3f} ms fp32, "
          f"{out['resnet_ms']['bf16']:.3f} ms bf16")
    return out


TRAINED = ("unet", "encoder")


def r4rn_train_phase(args, cuda_ops, device, counts, work):
    """r4rn_best trained on the collected store: one batch of 256 windows
    at fixed t and noise, the encoder trained, the gradients of the U-Net
    and the ResNet on the default path (K1) and on SPDM_CONV_BWD=pallas
    (K1 + K6) against the all-plain path (fp32 within GRAD_TOL of each
    tensor's largest |grad| or of GRAD_ZERO of the largest gradient of
    all, whichever is larger: `floored_grad_gap`; the encoder's tensors
    within GRAD_TOL of their own; amp within AMP_GRAD_FACTOR), launches
    exact;
    train-step ms at B=256 in fp32 and amp; one epoch through the CLI with
    `--vision_encoder resnet18 --train_encoder` (r5blend's recipe
    otherwise), its run served by load_run at 16 envs x 10 frames."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.cli import train_policy
    from state_policy_diffusionmodel_torch.data import (
        DeviceWindowDataset, WindowDataset,
    )
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    out = {}
    policy, params, _ = load_run(R4RN_DIR, device)
    if not policy.config.train_encoder:
        raise Failed("r4rn_best's hparams do not train the encoder")
    with phase("r4rn gradients on the card"):
        ds = WindowDataset(os.path.join(work, "card.zarr"), 10, 30, 5)
        twin = DeviceWindowDataset(ds, device)
        idx = np.random.default_rng(args.seed).permutation(len(ds))[:N_ENVS]
        batch = twin.batch(idx, image_frames=10)
        gen = torch.Generator(device=device).manual_seed(args.seed + 5)
        t = torch.randint(0, 1000, (N_ENVS,), generator=gen, device=device)
        noise = torch.randn((N_ENVS, 31, 5), generator=gen, device=device)
        plain_attn = lambda q, k, v, num_heads=1: \
            cuda_ops.AttentionCore.apply(cuda_ops.attention_core_ref,
                                         num_heads, q, k, v)
        ref = {}
        with conv_paths(cuda_ops, "xla9", "", plain_attn):
            for amp in (False, True):
                zero_counts()
                ref[amp] = unet_grads(policy, params, batch, t, noise, amp,
                                      TRAINED)
                if any(read_counts().values()):
                    raise Failed(f"the plain path launched {read_counts()}")
        plain_gap = rel_l2(ref[True][1], ref[False][1])
        print(f"  all-plain path: loss fp32 {ref[False][0].item():.6f}, amp "
              f"{ref[True][0].item():.6f}; amp gradient vs fp32: relative "
              f"L2 {plain_gap:.3e}")
        grads = {}
        for name in ("default", "conv_bwd"):
            cp, cb = TRAIN_PATHS[name]
            want = {"K1": 5, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                    "K6": 31 * (cb == "pallas")}
            grads[name] = {}
            for amp in (False, True):
                tag = "amp" if amp else "fp32"
                with conv_paths(cuda_ops, cp, cb):
                    zero_counts()
                    loss, g = unet_grads(policy, params, batch, t, noise,
                                         amp, TRAINED)
                    torch.cuda.synchronize()
                    n = read_counts()
                rec = dict(loss=loss.item(), launches=n,
                           rel_l2_vs_fp32_plain=rel_l2(g, ref[False][1]))
                if amp:
                    rec["limit"] = AMP_GRAD_FACTOR * plain_gap
                    ok = rec["rel_l2_vs_fp32_plain"] <= rec["limit"]
                else:
                    enc = {k: v for k, v in g.items()
                           if k.startswith("encoder.")}
                    _, worst_zero, zeros = grad_gap(g, ref[False][1])
                    rec.update(floored_grad_gap(g, ref[False][1]),
                               zero_tensors_max=worst_zero,
                               zero_tensors=len(zeros),
                               encoder_max_rel_err=grad_gap(enc, {
                                   k: ref[False][1][k] for k in enc})[0],
                               encoder_tensors=len(enc))
                    ok = (rec["max_rel_err"] <= GRAD_TOL
                          and rec["encoder_max_rel_err"] <= GRAD_TOL
                          and worst_zero <= GRAD_ZERO)
                grads[name][tag] = rec
                print(f"  {name:9s} {tag}: {fmt(rec)}", flush=True)
                if n != want:
                    raise Failed(f"r4rn gradients, {name} {tag}: launches "
                                 f"{n}, expected {want}")
                if not (ok and np.isfinite(rec["loss"])):
                    raise Failed(f"r4rn gradients, {name} {tag}: {rec}")
        for m in params.values():
            m.zero_grad(set_to_none=True)
        out["gradients"] = grads

    with phase("r4rn train-step timing"):
        steps = {}
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            rec = time_train_steps(policy, params, twin, args.seed, amp,
                                   device, counts)
            steps[tag] = rec
            print(f"  {tag}: {rec['ms']:.2f} ms a step (median of "
                  f"{TIMED_STEPS}: {[round(v, 2) for v in rec['ms_each']]}),"
                  f" {rec['samples_per_s']:.1f} samples/s, peak "
                  f"{rec['peak_gib']:.2f} GiB; launches a step "
                  f"{rec['launches_per_step']}", flush=True)
        out["step_ms"] = steps
    del twin

    run = os.path.join(work, "runs", "r4rn_recipe")
    with phase("r4rn training through the CLI"):
        zero_counts()
        t0 = time.perf_counter()
        res = train_policy.main([
            "--dataset_dir", work, "--dataset_name", "card.zarr",
            "--out_dir", os.path.join(work, "runs"), "--version",
            "r4rn_recipe", "--vision_encoder", "resnet18", "--train_encoder",
            "--seed", "42"] + RECIPE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = read_counts()
        with open(os.path.join(run, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e[k] for e in events for k in ("loss", "val_loss",
                                                 "train_loss") if k in e]
        missing = [p for p in ("checkpoints/epoch=0/params.npz",
                               "checkpoints_ema/epoch=0/params.npz",
                               "STATS.pkl", "hparams.yaml", "metrics.jsonl",
                               "trainer_state/opt/params.npz")
                   if not os.path.exists(os.path.join(run, p))]
        epoch = next(e for e in events if e["event"] == "epoch")
        print(f"  one epoch, --vision_encoder resnet18 --train_encoder, "
              f"{res['step']} steps of {N_ENVS} in {secs:.2f} s (the epoch "
              f"{epoch['seconds']:.2f} s, {epoch['samples_per_sec']:.1f} "
              f"samples/s); train loss {res['history']['train_loss']}, val "
              f"{res['history']['val_loss']}; launches {n}")
        if missing or not losses or not all(np.isfinite(losses)):
            raise Failed(f"r4rn CLI training: missing {missing}, losses "
                         f"{losses}")
        if not n["K1"] or any(n[k] for k in ("K2", "K3", "K4", "K5", "K6")):
            raise Failed(f"r4rn CLI training launched {n}")
        out["cli"] = dict(seconds=secs, steps=res["step"],
                          history=res["history"], launches=n,
                          epoch_seconds=epoch["seconds"],
                          samples_per_s=epoch["samples_per_sec"])

    with phase("serve the trained r4rn run"):
        tpol, tparams, tstats = load_run(run, device, ema=True)
        if type(tparams["encoder"]).__name__ != "ResNet18GN":
            raise Failed(f"the run loads a {type(tparams['encoder'])}")
        bank = load_or_build_bank(LOOP_TRACKS, bake=True, device=device)
        ids = torch.arange(DATA_ENVS, dtype=torch.int32,
                           device=device) % LOOP_TRACKS
        fn = diffusion.make_ring_policy(tpol, tstats, sampler="ddim",
                                        num_inference_steps=10,
                                        seed=args.seed)
        _, _, served = vector.rollout_policy(
            bank, diffusion.env_policy(fn, tparams),
            diffusion.init_ring_carry(tpol, DATA_ENVS), 10,
            auto_reset=False, track_ids=ids, device=device)
        a = served.actions
        print(f"  the EMA checkpoint serves {DATA_ENVS} envs x 10 frames: "
              f"actions {tuple(a.shape)}, mean |a| "
              f"{a.abs().mean().item():.4f}")
        if tuple(a.shape) != (10, DATA_ENVS, 3) or not bool(
                torch.isfinite(a).all()):
            raise Failed(f"the trained r4rn run serves actions "
                         f"{tuple(a.shape)}, or not finite")
        out["served"] = dict(frames=10, envs=DATA_ENVS,
                             mean_abs_action=a.abs().mean().item())
    return out


def autoencoder_phase(device, counts, work):
    """r3_autoencoder on the golden frames, card against CPU (AE_TOL), its
    MSE; AE_EPOCHS epochs of cli/train_autoencoder.py on the collected
    store at B=AE_BATCH (losses finite, the val loss falling, no port
    kernel launched); cli/train_policy.py --encoder_ckpt of that run (one
    epoch at width 8, r5blend's recipe otherwise) keeps its encoder leaf
    for leaf."""
    from state_policy_diffusionmodel_torch.cli import (
        train_autoencoder, train_policy,
    )
    from state_policy_diffusionmodel_torch.params_from_jax import params_to_jax
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    out = {}
    with np.load(GOLDEN) as g:
        frames = np.stack([g[k] for k in sorted(g.files)]).astype(
            np.float32) / 255.0
    x = torch.from_numpy(frames)
    with torch.no_grad():
        got = train_autoencoder.load_autoencoder(R3_DIR, device)(
            x.to(device)).cpu()
        want = train_autoencoder.load_autoencoder(R3_DIR, "cpu")(x)
    d = (got - want).abs().max().item()
    mse = ((got - x) ** 2).mean().item()
    out["r3"] = dict(frames=len(frames), card_vs_cpu_max=d, mse=mse)
    print(f"  r3_autoencoder on the {len(frames)} golden frames: card vs CPU "
          f"max |diff| {d:.3e} (tol {AE_TOL}); reconstruction MSE {mse:.6f}")
    if not d <= AE_TOL:
        raise Failed(f"r3 reconstructions: card and CPU differ by {d}")

    run = os.path.join(work, "ae_runs", "card")
    zero_counts()
    t0 = time.perf_counter()
    res = train_autoencoder.main([
        "--dataset", os.path.join(work, "card.zarr"), "--epochs",
        str(AE_EPOCHS), "--batch_size", str(AE_BATCH), "--out_dir",
        os.path.join(work, "ae_runs"), "--version", "card", "--device",
        str(device)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = read_counts()
    h = res["history"]
    out["train"] = dict(seconds=secs, history=h, launches=n,
                        steps=len(h["step_loss"]))
    print(f"  {AE_EPOCHS} epochs at B={AE_BATCH} on the collected frames, "
          f"{len(h['step_loss'])} steps in {secs:.2f} s: train "
          f"{h['train_loss']}, val {h['val_loss']}; launches {n}")
    if not (np.isfinite(h["step_loss"]).all()
            and np.isfinite(h["val_loss"]).all()
            and h["val_loss"][-1] < h["val_loss"][0]) or any(n.values()):
        raise Failed(f"autoencoder training: {h}, launches {n}")

    zero_counts()
    train_policy.main([
        "--dataset_dir", work, "--dataset_name", "card.zarr", "--out_dir",
        os.path.join(work, "runs"), "--version", "ae_encoder",
        "--encoder_ckpt", run, "--model_width", "8", "--seed", "42"]
        + RECIPE)
    _, params, _ = load_run(os.path.join(work, "runs", "ae_encoder"), device)
    mine = params_to_jax({"encoder": params["encoder"]})
    ae_leaves = params_to_jax({"encoder": train_autoencoder.load_autoencoder(
        run, "cpu").encoder})
    same = sorted(mine) == sorted(ae_leaves) and all(
        np.array_equal(mine[k], ae_leaves[k]) for k in mine)
    print(f"  cli/train_policy.py --encoder_ckpt of that run: one epoch at "
          f"width 8, its encoder equal to the run's "
          f"{'leaf for leaf' if same else 'NOT'}; launches {read_counts()}")
    if not same:
        raise Failed("the policy trained on the autoencoder run holds "
                     "another encoder")
    out["policy_cli_encoder_equal"] = same
    return out


# the slice of the remaining entry points: the native window gather, the
# sampling CLI, the live demo, the MFU table and the profiler
NATIVE_BATCH, NATIVE_REPEATS = 256, 5
# (sampler, --num_inference_steps, spacing): DDPM runs all 1,000 steps of
# r5blend's schedule whatever --num_inference_steps says, as in JAX
SAMPLE_CASES = [("DDPM", 100, "leading"), ("DDIM", 10, "leading"),
                ("DDIM", 10, "trailing"), ("DPMPP", 10, "trailing")]
# cli/run_predictions.py: one env on track 42 (built on the host), the
# lane follower driving for RP_PID_FRAMES frames, then a run in which the
# policy drives for RP_POLICY_FRAMES frames; --predict_every 50, DDIM-10
RP_TRACK, RP_PID_FRAMES, RP_POLICY_FRAMES = 42, 150, 100
# cli/mfu.py's rows: the denoiser forward at B=256 on both conv paths and
# the train step at B=16, fp32 and amp
MFU_BATCH, MFU_TRAIN_BATCH = 256, 16
# the profiler: cli/train_policy.py --profile_dir over one epoch of two
# steps (two collected episodes: 328 training windows at B=128), and
# bench --smoke --profile-dir in policy mode
PROFILE_TRAIN = ["--batch_size", "128", "--n_epochs", "1", "--no_early_stop",
                 "--no_sample_viz", "--device_data", "--encoder_ckpt",
                 RUN_DIR]
PROFILE_BENCH = ["--mode", "policy", "--smoke", "--run_dir", RUN_DIR]


def native_phase(work):
    """WindowDataset.batch of 256 windows of the collected store through
    the host library (C++ gather and normalization) against the same batch
    through the numpy plain versions: every array equal; each path's
    median ms over NATIVE_REPEATS batches."""
    from types import SimpleNamespace

    from state_policy_diffusionmodel_torch.data import dataset as D
    from state_policy_diffusionmodel_torch.data import native

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    ds = D.WindowDataset(os.path.join(work, "card.zarr"), 10, 30, 5)
    idx = np.random.default_rng(0).permutation(len(ds))[:NATIVE_BATCH]
    plain = SimpleNamespace(gather_windows=D.gather_windows,
                            normalize_positions=D.normalize_positions)
    got = ds.batch(idx, return_translations=True)
    with mock.patch.object(D, "native", plain):
        want = ds.batch(idx, return_translations=True)
    for k in got[0]:
        if not np.array_equal(got[0][k], want[0][k]):
            raise Failed(f"native batch: {k} differs from the numpy batch")
    if not np.array_equal(got[1], want[1]):
        raise Failed("native batch: the translations differ")

    def median_ms(fn):
        times = []
        for _ in range(NATIVE_REPEATS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    native_ms = median_ms(lambda: ds.batch(idx))
    with mock.patch.object(D, "native", plain):
        numpy_ms = median_ms(lambda: ds.batch(idx))
    print(f"  host library built or loaded in {build_s:.2f} s "
          f"({native.N_THREADS} threads); WindowDataset.batch of "
          f"{NATIVE_BATCH} windows x {ds.sequence_len} frames of "
          f"card.zarr: every array equal to the numpy plain version's; "
          f"{native_ms:.2f} ms a batch native, {numpy_ms:.2f} ms numpy "
          f"(median of {NATIVE_REPEATS}, host wall time)", flush=True)
    return dict(batch=NATIVE_BATCH, native_ms=native_ms, numpy_ms=numpy_ms,
                threads=native.N_THREADS, build_seconds=build_s)


def sample_phase(device, work, counts, cuda_ops, seed):
    """cli/sample.py's computation on the card: r5blend's EMA weights on the
    first validation window of the collected store (a seeded split), each
    of SAMPLE_CASES at one x_T: the history's shape and finiteness, its
    last row equal to the call without history, K1 launched 5 times a U-Net
    forward and nothing else, within ACTION_TOL of the same history on the
    plain attention path; the seconds of each sampling."""
    from state_policy_diffusionmodel_torch.cli import sample as S
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    policy, params, stats = load_run(RUN_DIR, device, ema=True)
    cfg = policy.config
    batch = S.load_window(policy, stats, work, "card.zarr", split_seed=seed)
    x_T = policy.init_noise(1, torch.Generator().manual_seed(seed))
    S.sample_history(policy, params, batch, "DDIM", 10, init_noise=x_T)
    out = {}
    for name, n, spacing in SAMPLE_CASES:
        run = lambda: S.sample_history(policy, params, batch, name, n,
                                       spacing, seed=seed, init_noise=x_T)
        torch.cuda.synchronize()
        # the sampling path: counts to 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        hist = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts()
        steps = cfg.noise_steps if name == "DDPM" else n
        tag = f"{name}-{steps} {spacing}" if name == "DDIM" \
            else f"{name}-{steps}"
        if tuple(hist.shape) != (steps + 1, 1, cfg.horizon,
                                 cfg.prediction_dim) or \
                not bool(torch.isfinite(hist).all()):
            raise Failed(f"{tag}: history {tuple(hist.shape)}, or not "
                         "finite")
        last = policy.sample(params, batch, torch.Generator().manual_seed(
            seed), sampler=S.SAMPLERS[name], num_inference_steps=n,
            ddim_spacing=spacing, init_noise=x_T)
        if not torch.equal(last, hist[-1]):
            raise Failed(f"{tag}: the history's last row differs from the "
                         "sample without history")
        want = {"K1": 5 * steps, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                "K6": 0}
        if got != want:
            raise Failed(f"{tag}: launches {got}, expected {want}")
        with mock.patch.object(cuda_ops, "attention_core",
                               cuda_ops.attention_core_ref):
            plain = run()
        d = (hist - plain).abs().max().item()
        out[tag] = dict(steps=steps, seconds=secs,
                        ms_a_step=secs * 1e3 / steps, launches=got,
                        vs_plain_max=d)
        print(f"  {tag}: history {tuple(hist.shape)} in {secs:.3f} s "
              f"({secs * 1e3 / steps:.2f} ms a step, B=1); launches {got}; "
              f"vs the plain attention path {d:.3e} (tol {ACTION_TOL})",
              flush=True)
        if not d <= ACTION_TOL:
            raise Failed(f"{tag}: the K1 path is {d} from the plain path")
    return out


def overlay_pixels(raster, bank, out):
    """Pixels of the last frame's state where the overlay draws red and the
    frame without it does not (two renders, outside any counted run)."""
    state = out["state"]
    with_ov = raster.render(state.car, bank, overlay=out["overlay"])[0]
    without = raster.render(state.car, bank)[0]
    red = torch.tensor(raster.PALETTE_U8[raster.L_POINTS],
                       device=with_ov.device)
    return int(((with_ov[0] == red).all(-1)
                & ~(without[0] == red).all(-1)).sum())


def run_predictions_phase(device, work, counts, seed):
    """cli/run_predictions.py's computation on the card: r5blend (EMA) and
    one env on track RP_TRACK; the lane follower drives RP_PID_FRAMES
    frames with a prediction every 50 once the 50-frame ring is full, then
    the policy drives RP_POLICY_FRAMES frames (a denoise every 5): one K2
    launch a frame and the reset's, 50 K1 a denoise (DDIM-10), nothing
    else; overlay pixels in the last frame; the frames saved as .npy in the
    work directory; frames/s."""
    from state_policy_diffusionmodel_torch.cli import run_predictions as RP
    from state_policy_diffusionmodel_torch.render import raster
    from state_policy_diffusionmodel_torch.train import load_run

    zero_counts, read_counts = counts
    policy, params, stats = load_run(RUN_DIR, device, ema=True)
    t0 = time.perf_counter()
    bank = RP.track_bank(RP_TRACK, device)
    build_s = time.perf_counter() - t0
    ring = policy.config.obs_horizon * policy.config.step_size
    out_all = {"track_build_seconds": build_s}
    for drive, steps in (("pid", RP_PID_FRAMES), ("policy", RP_POLICY_FRAMES)):
        torch.cuda.synchronize()
        # the demo's path: counts to 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        out = RP.run_predictions(policy, params, stats, bank, steps=steps,
                                 predict_every=50, drive=drive, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts()
        frames = out["frames"]
        every = policy.config.step_size if drive == "policy" else 50
        denoises = len([k for k in range(len(frames))
                        if k >= ring - 1 and k % every == 0])
        want = {"K1": 5 * 10 * denoises, "K2": len(frames) + 1, "K3": 0,
                "K4": 0, "K5": 0, "K6": 0}
        if got != want or out["denoises"] != denoises:
            raise Failed(f"run_predictions {drive}: launches {got} and "
                         f"{out['denoises']} denoises, expected {want} and "
                         f"{denoises}")
        if frames.shape != (steps, 96, 96, 3) or frames.dtype != np.uint8 \
                or not np.isfinite(out["actions"]).all():
            raise Failed(f"run_predictions {drive}: frames {frames.shape} "
                         f"{frames.dtype}, or actions not finite")
        red = overlay_pixels(raster, bank, out)
        path = os.path.join(work, f"run_predictions_{drive}.npy")
        np.save(path, frames)
        if not np.array_equal(np.load(path), frames):
            raise Failed(f"{path} reads back otherwise")
        out_all[drive] = dict(frames=len(frames), seconds=secs,
                              frames_per_s=len(frames) / secs,
                              denoises=denoises, launches=got,
                              overlay_pixels=red,
                              predictions=[k for k, _ in out["predictions"]])
        print(f"  --drive {drive}: {len(frames)} frames in {secs:.3f} s = "
              f"{len(frames) / secs:.1f} frames/s; {denoises} denoises at "
              f"frames {[k for k, _ in out['predictions']]} (drawn); "
              f"launches {got}; {red} overlay pixels in the last frame; "
              f"saved {os.path.basename(path)}", flush=True)
        if red == 0:
            raise Failed(f"run_predictions {drive}: no overlay pixel")
    return out_all


def mfu_phase(device, counts, cuda_ops, smi):
    """cli/mfu.py's rows on the card: the denoiser forward in bf16 at
    B=MFU_BATCH on the default conv path and on the conv kernels, the
    train step at B=MFU_TRAIN_BATCH in fp32 and amp (default path); every
    row's FLOP/s below the card's bf16 peak; each call's launches."""
    from state_policy_diffusionmodel_torch.cli import mfu

    zero_counts, read_counts = counts
    out = {"card": smi}
    per_run = 5 * mfu.K_INNER * (5 + 1)       # K1 a forward, warm-up + 5
    for tag, batches, train, amp, path in (
            ("forward, default path", (MFU_BATCH,), 0, False, "xla9"),
            ("forward, conv kernels", (MFU_BATCH,), 0, False, "pallas"),
            ("train step fp32", (), MFU_TRAIN_BATCH, False, "xla9"),
            ("train step amp", (), MFU_TRAIN_BATCH, True, "xla9")):
        torch.cuda.synchronize()
        zero_counts()
        res = mfu.mfu_rows(device, batches, train, amp, conv_path=path,
                           log=lambda m: print(f"  {m}", flush=True))
        torch.cuda.synchronize()
        got = read_counts()
        row = res["rows"][0]
        want = {"K1": per_run, "K2": 0, "K6": 0}
        if path == "pallas":
            want.update(K3=6 * per_run, K4=6 * per_run, K5=3 * per_run)
        else:
            want.update(K3=0, K4=0, K5=0)
        if got != want:
            raise Failed(f"mfu {tag}: launches {got}, expected {want}")
        if not 0 < row["tflops_per_sec"] * 1e12 < res["peak_flops"]:
            raise Failed(f"mfu {tag}: {row['tflops_per_sec']} TFLOP/s is not "
                         f"below the peak {res['peak_flops'] / 1e12}")
        out[tag] = dict(row, launches=got, peak_flops=res["peak_flops"])
    print(f"  card: {smi}", flush=True)
    return out


def trace_kernel_names(path):
    """The names of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def profile_phase(device, work):
    """The profiler on the card: cli/train_policy.py --profile_dir over an
    epoch of two train steps (the first two collected episodes, B=128,
    r5blend's encoder), and bench --smoke --profile-dir in policy mode on
    r5blend: each trace file written, with K1's kernel among its device
    events."""
    from state_policy_diffusionmodel_torch import bench
    from state_policy_diffusionmodel_torch.cli import train_policy
    from state_policy_diffusionmodel_torch.data import (
        ReplayBuffer, load_zarr, save_zarr,
    )

    buf = load_zarr(os.path.join(work, "card.zarr"))
    n = int(buf.episode_ends[1])
    save_zarr(ReplayBuffer({k: v[:n] for k, v in buf.data.items()},
                           buf.episode_ends[:2]),
              os.path.join(work, "two.zarr"))
    out = {}
    for tag, call in (
            ("train_policy --profile_dir", lambda d: train_policy.main([
                "--dataset_dir", work, "--dataset_name", "two.zarr",
                "--out_dir", os.path.join(work, "prof_runs"), "--version",
                "p", *PROFILE_TRAIN, "--profile_dir", d])),
            ("bench --smoke --profile-dir", lambda d: bench.main([
                *PROFILE_BENCH, "--profile-dir", d]))):
        d = os.path.join(work, "prof_" + tag.split()[0])
        t0 = time.perf_counter()
        res = call(d)
        secs = time.perf_counter() - t0
        traces = sorted(p for p in os.listdir(d) if p.endswith(".json"))
        if len(traces) != 1:
            raise Failed(f"{tag}: traces {traces} in {d}")
        path = os.path.join(d, traces[0])
        names = trace_kernel_names(path)
        k1 = sorted(n for n in names if "attention_core_kernel" in n)
        print(f"  {tag}: {secs:.2f} s, trace {traces[0]} "
              f"({os.path.getsize(path) / 2**20:.1f} MiB), "
              f"{len(names)} kernel names, K1's: {k1}", flush=True)
        if not k1:
            raise Failed(f"{tag}: K1's kernel is not among the trace's "
                         "device events")
        out[tag] = dict(seconds=secs, trace_mib=os.path.getsize(path) / 2**20,
                        kernel_names=len(names), k1_names=k1)
        if tag.startswith("train"):
            out[tag]["steps"] = int(res["step"])
    return out


# ---------------------------------------------------------------------------
# multi-device and zstd phases
# ---------------------------------------------------------------------------

# the multi-device phase: r5blend's sharded closed loop (DDIM-10 leading,
# render on, from a reset: 4 denoises), and r5blend's recipe for two
# data-parallel train steps at the global batch
MD_ENVS, MD_FRAMES, MD_STEPS, MD_LAUNCH_TIMEOUT = 256, 20, 2, 300.0
MD_RECIPE = dict(batch_size=256, lr=4e-4, lr_schedule="cosine", min_lr=1e-6,
                 ema_decay=0.9995, device_data=True, early_stop=False)
# the JAX multi-device test's limits (tests/test_train.py): losses within
# rtol 1e-5, params within rtol 1e-3 / atol 1e-5. The attention key
# biases get no gradient in exact arithmetic: Adam moves them by up to lr
# a step whatever the sign of their rounding-level gradients, so they are
# held within the 2 * lr a step that the two sides can move apart (Adam's
# ceiling, which they reach when the signs differ) and reported apart
# from the other tensors
MD_LOSS_RTOL, MD_PARAM_RTOL, MD_PARAM_ATOL = 1e-5, 1e-3, 1e-5
# the shared eval store of the JAX package (blosc zstd-5 with bitshuffle)
# and the accuracy record taken on it (other weights: a reference, not a
# target; ROADMAP.md Queue 3 item 1)
SHARED_DIR = os.path.join(HERE, "data", "eval_shared")
SHARED_NAME = "shared_eval_dataset_6_episodes_3_drivers.zarr"
SHARED_RECORD = os.path.join(HERE, "results", "r5", "acc_r5blend_ema.json")
SHARED_ARGS = ["accuracy", "--run_dir", RUN_DIR, "--ema", "--gaussian_init",
               "--dataset_dir", SHARED_DIR, "--dataset_name", SHARED_NAME,
               "--max_windows", "120", "--sampler", "ddim",
               "--num_inference_steps", "10", "--ddim_spacing", "leading",
               "--device", "cuda"]


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def md_loop(mesh, seed):
    """r5blend's closed loop over MD_ENVS envs on the 4-track bank, split
    over the mesh's ranks (the whole batch on a one-process mesh): this
    rank's K1 and K2 launches (counts to 0 just before, read just after),
    its frames/s, and the gathered (T, B, 3) actions on the CPU."""
    from state_policy_diffusionmodel_torch import diffusion
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.models import cuda_ops
    from state_policy_diffusionmodel_torch.render import cuda_sampler
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    _tf32_off()
    dev = mesh.device
    policy, params, stats = load_run(RUN_DIR, dev)
    bank = load_or_build_bank(LOOP_TRACKS, bake=True, device=dev)
    ids = torch.arange(MD_ENVS, device=dev) % LOOP_TRACKS

    def drive(n_frames):
        fn = diffusion.make_ring_policy(policy, stats, sampler="ddim",
                                        num_inference_steps=10, seed=seed)
        if mesh.group is None:
            _, _, out = vector.rollout_policy(
                bank, diffusion.env_policy(fn, params),
                diffusion.init_ring_carry(policy, MD_ENVS), n_frames,
                auto_reset=False, track_ids=ids, device=dev)
            return out.actions
        _, _, acts, _ = vector.rollout_policy_sharded(
            mesh, params, bank, diffusion.env_policy_fn(fn),
            diffusion.init_ring_carry(policy, MD_ENVS), n_frames,
            auto_reset=False, track_ids=ids)
        return acts

    drive(5)                                                 # warm-up
    torch.cuda.synchronize(dev)
    cuda_ops.attention_core.launches = 0
    cuda_sampler.sample_banked.launches = 0
    t0 = time.perf_counter()
    acts = drive(MD_FRAMES)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return dict(rank=mesh.rank, world_size=mesh.world_size,
                backend=mesh.backend, seconds=secs,
                fps=MD_ENVS // mesh.world_size * MD_FRAMES / secs,
                K1=cuda_ops.attention_core.launches,
                K2=cuda_sampler.sample_banked.launches,
                actions=acts.cpu())


def md_steps(mesh, store, seed, out_dir):
    """MD_STEPS data-parallel steps of r5blend's recipe from r5blend's
    weights at the global batch MD_RECIPE["batch_size"] (this rank's rows
    of it; t and the noise drawn at the global shape from one generator
    seeded `seed`): the losses averaged over the ranks, the ms of each step
    (host wall time ending in a synchronize), and every U-Net and encoder
    tensor on the CPU."""
    from state_policy_diffusionmodel_torch.data.dataset import DataModule
    from state_policy_diffusionmodel_torch.parallel import mean_over_ranks
    from state_policy_diffusionmodel_torch.train import load_run, loop

    _tf32_off()
    dev = mesh.device
    policy, params, _ = load_run(RUN_DIR, dev)
    cfg = loop.TrainConfig(**MD_RECIPE)
    dm = DataModule(batch_size=cfg.batch_size, data_dir=os.path.dirname(store),
                    T_obs=10, T_pred=30, seed=seed, step_size=5)
    dm.setup(os.path.basename(store))
    trainer = loop.Trainer(policy, cfg, out_dir, mesh=mesh)
    trainer._device_ds(dm)                  # the twin, before the clock
    ema = copy.deepcopy(params)
    step = loop.make_train_step(policy, params,
                                loop.make_optimizer(cfg, params),
                                ema=ema, ema_decay=cfg.ema_decay, mesh=mesh)
    order = np.random.default_rng(seed).permutation(dm.train_idx)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, ms = [], []
    for i in range(MD_STEPS):
        idx = order[i * cfg.batch_size:(i + 1) * cfg.batch_size]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        batch, t, noise = trainer._batch(dm, idx, gen)
        losses.append(step(batch, cfg.lr, t=t, noise=noise))
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(rank=mesh.rank, world_size=mesh.world_size,
                backend=mesh.backend, ms=ms,
                losses=mean_over_ranks(torch.stack(losses), mesh).cpu(),
                params={f"{m}.{k}": v.detach().cpu()
                        for m, mod in params.items()
                        for k, v in mod.state_dict().items()})


def md_rank(mesh, seed, store, out_dir):
    """Both multi-device checks in one spawned rank."""
    return dict(loop=md_loop(mesh, seed),
                steps=md_steps(mesh, store, seed, out_dir))


def md_compare_steps(got, want, what):
    """`got`'s steps against `want`'s: the losses' largest relative gap,
    the tensor that comes closest to its limit but the key biases (its
    name and the reading, the largest |difference| over the limit), and
    the key biases' reading against Adam's ceiling. Raises past a
    limit."""
    gl, wl = got["losses"].double(), want["losses"].double()
    loss_gap = ((gl - wl).abs() / wl.abs()).max().item()
    if not loss_gap <= MD_LOSS_RTOL:
        raise Failed(f"{what}: losses {gl.tolist()} against {wl.tolist()}")
    worst_key, worst, key_bias = None, 0.0, 0.0
    for k, w in want["params"].items():
        g = got["params"][k]
        d = (g.double() - w.double()).abs()
        if k.endswith("key.bias"):
            limit = torch.full_like(d, 2 * MD_STEPS * MD_RECIPE["lr"] * 1.001)
            key_bias = max(key_bias, (d / limit).max().item())
        else:
            limit = MD_PARAM_ATOL + MD_PARAM_RTOL * w.double().abs()
            reading = (d / limit).max().item()
            if worst_key is None or reading > worst:
                worst_key, worst = k, reading
        if not bool((d <= limit).all()):
            raise Failed(f"{what}: {k} off by {d.max().item():.3e}")
    return dict(loss_rel_gap=loss_gap, param_worst=worst_key,
                param_gap_of_limit=worst, key_bias_of_ceiling=key_bias)


def md_gaps_text(gaps):
    return (f"loss gap {gaps['loss_rel_gap']:.2e} (rtol {MD_LOSS_RTOL}), "
            f"params: {gaps['param_worst']} at "
            f"{gaps['param_gap_of_limit']:.3f} of its limit, the key biases "
            f"at {gaps['key_bias_of_ceiling']:.3f} of Adam's ceiling")


def multi_device_phase(args, device, smi, work):
    """Two gloo ranks on the one card (the sharded closed loop and two
    data-parallel train steps of r5blend's recipe) against one process;
    the world-size-1 NCCL step against the no-group step; NCCL across
    the cards when there are two or more."""
    import torch.distributed as dist

    from state_policy_diffusionmodel_torch.parallel import Mesh, make_mesh
    from state_policy_diffusionmodel_torch.parallel.launch import launch

    store = os.path.join(work, "card.zarr")
    out = {"card": smi}
    # the keyed x_T of one denoise at MD_ENVS envs: drawn on the host and
    # copied to the card (host wall time, ending in a synchronize)
    from state_policy_diffusionmodel_torch.diffusion import keyed_init_noise

    draw_ms = []
    for k0 in range(0, 105, 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(keyed_init_noise(np.arange(MD_ENVS), k0, (31, 5),
                                          args.seed)).to(device)
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    out["keyed_x_T_ms"] = float(np.median(draw_ms[1:]))
    print(f"  keyed x_T at {MD_ENVS} envs: {out['keyed_x_T_ms']:.3f} ms a "
          f"denoise (host draw and copy, median of 20)", flush=True)
    one = Mesh(0, 1, device)
    ref_loop = md_loop(one, args.seed)
    ref_steps = md_steps(one, store, args.seed, os.path.join(work, "md1"))
    print(f"  one process: {MD_ENVS} envs x {MD_FRAMES} frames at "
          f"{ref_loop['fps']:.1f} frames/s (K1 {ref_loop['K1']}, K2 "
          f"{ref_loop['K2']}); steps {[round(m, 2) for m in ref_steps['ms']]}"
          f" ms, losses {ref_steps['losses'].tolist()}", flush=True)
    out["one_process"] = dict(fps=ref_loop["fps"], K1=ref_loop["K1"],
                              K2=ref_loop["K2"], step_ms=ref_steps["ms"],
                              losses=ref_steps["losses"].tolist())

    def check(ranks, tag):
        rec = []
        per = MD_ENVS // len(ranks)
        want_k1 = 5 * 10 * (MD_FRAMES // 5)
        for r in ranks:
            lp, st = r["loop"], r["steps"]
            d = (lp["actions"] - ref_loop["actions"]).abs().max().item()
            gaps = md_compare_steps(st, ref_steps, tag)
            print(f"  {tag}, rank {lp['rank']} of {lp['world_size']} "
                  f"({lp['backend']}): {per} envs x {MD_FRAMES} frames at "
                  f"{lp['fps']:.1f} frames/s, K1 {lp['K1']} (want "
                  f"{want_k1}), K2 {lp['K2']} (want {MD_FRAMES + 1}); "
                  f"gathered actions vs one process: max {d:.3e} (tol "
                  f"{ACTION_TOL}); steps "
                  f"{[round(m, 2) for m in st['ms']]} ms at B="
                  f"{MD_RECIPE['batch_size'] // len(ranks)} a rank, "
                  f"{md_gaps_text(gaps)}; card: {smi}", flush=True)
            if (lp["K1"], lp["K2"]) != (want_k1, MD_FRAMES + 1):
                raise Failed(f"{tag}: rank {lp['rank']} launched K1 "
                             f"{lp['K1']}, K2 {lp['K2']}")
            if not d <= ACTION_TOL:
                raise Failed(f"{tag}: the sharded loop's actions differ "
                             f"from one process's by {d}")
            rec.append(dict(rank=lp["rank"], backend=lp["backend"],
                            envs=per, fps=lp["fps"], K1=lp["K1"],
                            K2=lp["K2"], actions_max_diff=d,
                            step_ms=st["ms"], **gaps))
        return rec

    ranks = launch(md_rank, 2, str(device), backend="gloo",
                   args=(args.seed, store, os.path.join(work, "md2")),
                   timeout=MD_LAUNCH_TIMEOUT)
    out["gloo_2_ranks_one_card"] = check(ranks, "2 gloo ranks on one card")

    # world size 1 over NCCL: the steps through NCCL's all_reduce
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "nccl_rendezvous"), rank=0, world_size=1)
    try:
        nccl = md_steps(make_mesh(device), store, args.seed,
                        os.path.join(work, "md_nccl"))
    finally:
        dist.destroy_process_group()
    if nccl["backend"] != "nccl":
        raise Failed(f"the world-size-1 mesh ran on {nccl['backend']}")
    gaps = md_compare_steps(nccl, ref_steps, "NCCL, 1 rank")
    print(f"  NCCL, world size 1: steps {[round(m, 2) for m in nccl['ms']]}"
          f" ms, {md_gaps_text(gaps)} against the no-group steps",
          flush=True)
    out["nccl_world_1"] = dict(step_ms=nccl["ms"], **gaps)

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # a rank a card, as many cards as split the batch and the envs
        n = max(k for k in range(2, n_cards + 1) if MD_ENVS % k == 0
                and MD_RECIPE["batch_size"] % k == 0)
        ranks = launch(md_rank, n, "cuda", backend="nccl",
                       args=(args.seed, store, os.path.join(work, "mdn")),
                       timeout=MD_LAUNCH_TIMEOUT)
        out["nccl_across_cards"] = check(ranks, f"NCCL across {n} cards")
    else:
        print(f"  NCCL across cards: not run, {n_cards} card present")
        out["nccl_across_cards"] = f"not run: {n_cards} card present"
    return out


def zstd_phase(counts, smi):
    """The JAX package's shared eval store read through the host library's
    zstd decoder; every img chunk encoded again by its zstd encoder and
    decoded, equal, its bytes against c-blosc's; then cli/evaluate.py's
    accuracy of r5blend (EMA) on it: K1 in every denoise and no other
    kernel."""
    from state_policy_diffusionmodel_torch.cli import evaluate
    from state_policy_diffusionmodel_torch.data import native
    from state_policy_diffusionmodel_torch.data.replay_buffer import (
        _blosc_decode, load_zarr,
    )

    zero_counts, read_counts = counts
    path = os.path.join(SHARED_DIR, SHARED_NAME)
    t0 = time.perf_counter()
    buf = load_zarr(path)
    secs = time.perf_counter() - t0
    nbytes = sum(v.nbytes for v in buf.data.values())
    shapes = {k: tuple(v.shape) for k, v in buf.data.items()}
    print(f"  {path}: six arrays {shapes}, {nbytes / 1e6:.1f} MB decoded in "
          f"{secs:.2f} s = {nbytes / 1e6 / secs:.1f} MB/s (host)", flush=True)
    img = buf.data["img"]
    if shapes.get("img") != (12000, 96, 96, 3) or len(shapes) != 6 or \
            not np.isfinite(img).all() or img.min() < 0 or img.max() > 1 or \
            buf.episode_ends.tolist() != list(range(2000, 12001, 2000)):
        raise Failed(f"the shared store read as {shapes}, episode ends "
                     f"{buf.episode_ends.tolist()}")
    with open(os.path.join(path, "data", "img", ".zarray")) as f:
        rows = json.load(f)["chunks"][0]
    ours = theirs = 0
    enc_s = 0.0
    for i in range(-(-len(img) // rows)):
        block = np.zeros((rows,) + img.shape[1:], img.dtype)
        part = img[i * rows:(i + 1) * rows]
        block[:len(part)] = part
        raw = block.tobytes()
        t0 = time.perf_counter()
        blob = native.blosc_compress(raw, 4, "zstd", 5, 2)
        enc_s += time.perf_counter() - t0
        if _blosc_decode(blob) != raw:
            raise Failed(f"img chunk {i}: the port's blosc zstd chunk does "
                         "not decode to its bytes")
        ours += len(blob)
        theirs += os.path.getsize(os.path.join(path, "data", "img",
                                               f"{i}.0.0.0"))
    enc_mb = img.nbytes / 1e6
    print(f"  every img chunk ({i + 1}) encoded by the port (blosc zstd-5, "
          f"bitshuffle, {native.N_THREADS} threads) in {enc_s:.2f} s = "
          f"{enc_mb / enc_s:.1f} MB/s (host) and decoded equal: {ours} "
          f"bytes against c-blosc's {theirs} on disk ({ours / theirs:.4f}x)"
          f"; card: {smi}", flush=True)
    del buf, img
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = evaluate.main(SHARED_ARGS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n = read_counts()
    acc = res["accuracy"]
    wps = len(acc["per_window_error"]) / acc["seconds"]
    record = None
    if os.path.exists(SHARED_RECORD):
        with open(SHARED_RECORD) as f:
            record = json.load(f)["accuracy"]["overall"]
    print(f"  accuracy of r5blend (EMA, gaussian x_T, DDIM-10) on "
          f"{len(acc['per_window_error'])} windows: overall "
          f"{acc['overall']:.4f}, action overall {acc['action_overall']:.4f}"
          f"; {wps:.1f} windows/s ({eval_s:.2f} s with the store's load); "
          f"launches "
          f"{n}; the JAX record (other weights, a reference): "
          f"{record if record is not None else 'not in this copy'}",
          flush=True)
    if not n["K1"] or any(n[k] for k in ("K2", "K3", "K4", "K5", "K6")):
        raise Failed(f"the shared-set accuracy launched {n}")
    if len(acc["per_window_error"]) != 120 or not np.isfinite(
            acc["overall"]):
        raise Failed(f"the shared-set accuracy: {acc['overall']} over "
                     f"{len(acc['per_window_error'])} windows")
    return dict(decoded_mb=nbytes / 1e6, read_s=secs,
                mb_per_s=nbytes / 1e6 / secs, img_encode_s=enc_s,
                img_encode_mb_per_s=enc_mb / enc_s, img_port_bytes=ours,
                img_cblosc_bytes=theirs, accuracy_overall=acc["overall"],
                action_overall=acc["action_overall"], eval_s=eval_s,
                windows_per_s=wps, launches=n, jax_record_overall=record)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run alone after the "
                         "build (k1, k2, k4, md), for iterating on a kernel "
                         "or on the multi-device path")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from state_policy_diffusionmodel_torch import (
        bench, diffusion, physics, track,
    )
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.kernels import build
    from state_policy_diffusionmodel_torch.models import cuda_ops
    from state_policy_diffusionmodel_torch.render import cuda_sampler, raster
    from state_policy_diffusionmodel_torch.track import load_or_build_bank
    from state_policy_diffusionmodel_torch.train import load_run

    # every kernel's launch count: on the wrapper (K3-K5) or on its
    # dispatcher (K1, K2), the owner also while a check has the module's
    # dispatcher patched over
    counted = {"K1": cuda_ops.attention_core, "K2": cuda_sampler.sample_banked,
               "K3": cuda_ops.conv3x3_cuda, "K4": cuda_ops.gn_act_cuda,
               "K5": cuda_ops.double_conv_cuda, "K6": cuda_ops.conv_dw_cuda}

    def zero_counts():
        for f in counted.values():
            f.launches = 0

    def read_counts():
        return {k: f.launches for k, f in counted.items()}

    with phase("device"):
        smi = nvidia_smi_line()
        nvcc_v = subprocess.run([build.nvcc(), "--version"],
                                capture_output=True, text=True,
                                timeout=60).stdout.strip().splitlines()[-1]
        print(f"  card: {smi}")
        print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
              f"python {sys.version.split()[0]}, nvcc: {nvcc_v}")
        print(f"  tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
              f"cudnn {torch.backends.cudnn.allow_tf32}")

    with phase("build"):
        built = build.build_all()
        for b in built.values():
            print(f"  {b.name}: {b.seconds:.2f} s -> "
                  f"{os.path.relpath(b.path, HERE)}")
            for line in b.log.strip().splitlines():
                print(f"    {line}")

    only = set(args.only.split(",")) if args.only else None
    if only is not None and not only <= {"k1", "k2", "k4", "md"}:
        raise Failed(f"--only takes k1, k2, k4 and md, got {args.only}")
    want = lambda k: only is None or k in only
    k1 = k1_ptxas = k1_unets = k4 = k4_ptxas = None
    if want("k1"):
        with phase("K1 attention_core vs plain"):
            k1, k1_ptxas = check_k1(cuda_ops, device, build)
        with phase("K1 on U-Net forwards off r5blend's path"):
            k1_unets = check_k1_unets(cuda_ops, device, args.seed)
    if only is None:
        with phase("K3 conv3x3 vs plain"):
            k3, k3_ptxas = check_k3(cuda_ops, device, build)
    if want("k4"):
        with phase("K4 gn_act vs plain"):
            k4, k4_ptxas = check_k4(cuda_ops, device, build)
    if only is not None:
        if want("k2"):
            with phase("K2 sample_banked vs plain"):
                k2, k2_ptxas = check_k2(k2_cases(args.seed, device), build)
        multi = None
        if want("md"):
            work = tempfile.mkdtemp(prefix="chip_smoke_data_")
            try:
                with phase("collect"):
                    collect_phase(device, work, (zero_counts, read_counts),
                                  smi)
                with phase("multi-device"):
                    multi = multi_device_phase(args, device, smi, work)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"k1": k1, "k1_ptxas": k1_ptxas,
                          "k1_unets": k1_unets, "k4": k4,
                          "k4_ptxas": k4_ptxas,
                          "k2": k2 if want("k2") else None,
                          "multi_device": multi}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    with phase("K5 double_conv vs plain"):
        k5 = check_k5(cuda_ops, device)
    with phase("K3-K5 at UNetSimple's shapes"):
        no_spills(k3_ptxas, "conv3x3_", "K3")
        k3_simple, _ = check_k3(cuda_ops, device, build,
                                conv_calls(SIMPLE_DC_SHAPES))
        k4_simple, _ = check_k4(cuda_ops, device, build,
                                gn_calls(SIMPLE_DC_SHAPES))
        k5_simple = check_k5(cuda_ops, device, SIMPLE_DC_SHAPES)
    with phase("UNetSimple forward on the conv kernels"):
        simple = unet_simple_phase(cuda_ops, device, args.seed,
                                   (zero_counts, read_counts))
    with phase("K6 conv_dw vs plain"):
        k6, k6_ptxas = check_k6(cuda_ops, device, build)
        k1_bwd_ms = attention_bwd_ms(cuda_ops, device)
        print(f"  K1's backward (plain torch, as JAX), the five calls of a "
              f"training step at B={N_ENVS}, fp32: {k1_bwd_ms:.4f} ms")

    with phase("K2 sample_banked vs plain, random poses"):
        cases = k2_cases(args.seed, device)
        k2, k2_ptxas = check_k2(cases[:2], build)

    with phase("golden frames on the card"):
        cars = physics.load_pickled_states(GOLDEN_STATES, device)
        golden_bank = track.stack([track.build(track.make_track(11),
                                               device=device)])
        counts = []
        with np.load(GOLDEN) as g:
            for i, car in enumerate(cars):
                obs, augm = raster.render(car, golden_bank)
                counts.append((int(frame_bytes(obs.cpu(),
                                               torch.from_numpy(g[f"f{i}_obs"])
                                               [None])[0]),
                               int(frame_bytes(augm.cpu(), torch.from_numpy(
                                   g[f"f{i}_augm"])[None])[0])))
            car = cars[-1]
            pts = torch.stack([torch.stack([
                car.pos[0] + torch.tensor([i * 1.0, j * 2.0], device=device)
                for j in range(5)]) for i in range(3)])
            ov = raster.Overlay(points=pts, valid=torch.tensor(
                [True, True, False], device=device))
            obs, augm = raster.render(car, golden_bank, overlay=ov)
            counts.append((
                int(frame_bytes(obs.cpu(), torch.from_numpy(g["f5_obs"])[None])
                    [0]),
                int(frame_bytes(augm.cpu(),
                                torch.from_numpy(g["f5_augm"])[None])[0])))
        print(f"  {len(cars)} car states on track 11 and the overlay frame: "
              f"bytes differing from golden_frames.npz (obs, augm): {counts}"
              f" (budget {FRAME_BUDGET} of 27648)")
        if max(max(c) for c in counts) > FRAME_BUDGET:
            raise Failed(f"golden frames differ by {counts} bytes")

    with phase("env card vs cpu"):
        n_envs, n_steps = 16, 40
        card = env_trace(device, n_envs, n_steps, args.seed)
        host = env_trace(torch.device("cpu"), n_envs, n_steps, args.seed)
        worst_pos, worst_bytes = 0.0, 0
        for k, (a, b) in enumerate(zip(card, host)):
            for name, x, y in zip(("reward", "done", "tiles"), a[:3], b[:3]):
                if not torch.equal(x, y):
                    raise Failed(f"env step {k}: {name} differs between the "
                                 f"card and the CPU: {x} vs {y}")
            worst_pos = max(worst_pos, (a[3] - b[3]).abs().max().item())
            worst_bytes = max(worst_bytes, int(frame_bytes(a[4], b[4]).max()),
                              int(frame_bytes(a[5], b[5]).max()))
        print(f"  {n_envs} envs x {n_steps} steps: rewards, done flags and "
              f"tile counts equal; positions differ by at most {worst_pos:.3g}"
              f" (tol {ENV_POS_TOL}); frames by at most {worst_bytes} bytes "
              f"(budget {FRAME_BUDGET}); tiles at the end "
              f"{card[-1][2].tolist()}")
        if worst_pos > ENV_POS_TOL or worst_bytes > FRAME_BUDGET:
            raise Failed("env on the card parts from the CPU")

    envs_run = {}
    with phase("env throughput"):
        for mode, render in (("env_only", False), ("env_render", True)):
            # the path: counts to 0 just before, read just after
            zero_counts()
            sps, times = bench.bench_env(ENV_B, ENV_STEPS, ENV_REPEATS,
                                         render, ENV_TRACKS, device=device)
            k2_n = cuda_sampler.sample_banked.launches
            if any(read_counts()[k] for k in ("K1", "K3", "K4", "K5")):
                raise Failed(f"{mode}: launches {read_counts()}")
            want = (ENV_REPEATS + 1) * ENV_STEPS if render else 0
            envs_run[mode] = dict(steps_per_s=sps, seconds=times,
                                  k2_launches=k2_n)
            print(f"  {mode}: {ENV_B} envs x {ENV_STEPS} steps, "
                  f"{ENV_TRACKS}-track bank: {sps:.1f} steps/s (runs "
                  f"{[round(t, 3) for t in times]} s), K2 launches {k2_n}",
                  flush=True)
            if k2_n != want:
                raise Failed(f"{mode}: {k2_n} K2 launches, expected {want}")

    with phase("K2 sample_banked vs plain, env poses"):
        k2 += check_k2(cases[2:])[0]

    with phase("policy load"):
        policy, params, stats = load_run(RUN_DIR, device)
        n_keys = sum(len(m.state_dict()) for m in params.values())
        if n_keys != 194:
            raise Failed(f"r5blend loaded {n_keys} tensors, expected 194")
        stream = observation_stream(stats, args.seed, device)
        print(f"  r5blend: {n_keys} tensors, width {params['unet'].width}, "
              f"{N_ENVS} envs x {N_FRAMES} frames")

    def make(amp):
        return diffusion.make_ring_policy(
            policy, stats, sampler="ddim", num_inference_steps=10,
            amp=amp, seed=args.seed)

    runs, acts = {}, {}
    with phase("policy rollouts"):
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            fn = make(amp)
            rollout(fn, params, diffusion.init_ring_carry(policy, N_ENVS),
                    stream, 5)                               # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            acts[tag], _ = rollout(fn, params,
                                   diffusion.init_ring_carry(policy, N_ENVS),
                                   stream, N_FRAMES)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = cuda_ops.attention_core.launches
            if any(read_counts()[k] for k in ("K3", "K4", "K5")):
                raise Failed(f"{tag}: conv kernels ran on the default conv "
                             f"path: {read_counts()}")
            # the same rollout on the plain path, holding K1 against it on
            # the policy's own activations as it goes
            shadow = ShadowAttention(cuda_ops)
            with mock.patch.object(cuda_ops, "attention_core", shadow):
                acts[tag + "_plain"], _ = rollout(
                    fn, params, diffusion.init_ring_carry(policy, N_ENVS),
                    stream, N_FRAMES)
            torch.cuda.synchronize()
            a = acts[tag]
            if tuple(a.shape) != (N_FRAMES, N_ENVS, 3):
                raise Failed(f"{tag}: actions of shape {tuple(a.shape)}")
            if not torch.isfinite(a).all():
                raise Failed(f"{tag}: non-finite actions")
            k1_real = shadow.summary()
            runs[tag] = dict(seconds=secs, launches=launches,
                             fps=N_ENVS * N_FRAMES / secs,
                             k1_on_policy=k1_real,
                             vs_plain=spread(a, acts[tag + "_plain"]))
            print(f"  {tag}: {N_ENVS * N_FRAMES} frames in {secs:.3f} s = "
                  f"{runs[tag]['fps']:.1f} frames/s, K1 launches {launches}",
                  flush=True)
            print(f"  {tag}: K1 vs plain on the policy's activations "
                  f"({k1_real['calls']} calls): {fmt(k1_real)}", flush=True)
            print(f"  {tag}: actions vs its plain path: "
                  f"{fmt(runs[tag]['vs_plain'])}", flush=True)
            if launches != 5 * 10 * (N_FRAMES // policy.config.step_size):
                raise Failed(f"{tag}: {launches} K1 launches, expected 500")
            dtype = torch.bfloat16 if amp else torch.float32
            if not k1_real["max_rel_err"] <= K1_REL_TOL[dtype]:
                raise Failed(f"{tag}: K1 differs from its plain version on "
                             f"the policy's activations by "
                             f"{k1_real['max_rel_err']} of the largest "
                             f"output > {K1_REL_TOL[dtype]}")
        if not runs["fp32"]["vs_plain"]["max"] <= ACTION_TOL:
            raise Failed(f"fp32 actions differ from the plain path by "
                         f"{runs['fp32']['vs_plain']['max']} > {ACTION_TOL}")

        # bf16 sensitivity: the amp plain path against itself with one
        # bf16 ulp added to or taken from a share of K1's outputs equal to
        # the share where the kernel and the plain version differ
        share = runs["amp"]["k1_on_policy"]["share_differ"]
        nudged = NudgedAttention(cuda_ops, share, args.seed, device)
        with mock.patch.object(cuda_ops, "attention_core", nudged):
            a_nudged, _ = rollout(make(True), params,
                                  diffusion.init_ring_carry(policy, N_ENVS),
                                  stream, N_FRAMES)
        runs["amp"]["nudged_vs_plain"] = spread(a_nudged, acts["amp_plain"])
        print(f"  amp plain path with one ulp on {share:.3g} of K1's outputs, "
              f"vs the amp plain path: "
              f"{fmt(runs['amp']['nudged_vs_plain'])}", flush=True)
        # control: the amp plain path rerun as it was gives the same actions
        with mock.patch.object(cuda_ops, "attention_core",
                               cuda_ops.attention_core_ref):
            a_rerun, _ = rollout(make(True), params,
                                 diffusion.init_ring_carry(policy, N_ENVS),
                                 stream, N_FRAMES)
        runs["amp"]["plain_rerun_vs_plain"] = spread(a_rerun,
                                                     acts["amp_plain"])
        print(f"  amp plain path rerun vs the amp plain path: "
              f"{fmt(runs['amp']['plain_rerun_vs_plain'])}", flush=True)
        # amp held against the fp32 plain path, the kernel's run and the
        # plain version's alike
        for tag in ("amp", "amp_plain"):
            sp = spread(acts[tag], acts["fp32_plain"])
            runs["amp"][f"{tag}_vs_fp32_plain"] = sp
            print(f"  {tag} vs fp32 plain: {fmt(sp)} (limits: mean "
                  f"{AMP_MEAN_TOL}, share over {AMP_FAR} {AMP_SHARE_TOL})",
                  flush=True)
            if not (sp["mean"] <= AMP_MEAN_TOL
                    and sp["share_over"] <= AMP_SHARE_TOL):
                raise Failed(f"{tag} actions too far from the fp32 plain "
                             f"path: {sp}")

    denoises = N_FRAMES // policy.config.step_size
    want_n = {"K1": 5 * 10 * denoises, "K3": 30 * 10 * denoises,
              "K4": 30 * 10 * denoises, "K5": 15 * 10 * denoises}
    conv_path = lambda: mock.patch.object(cuda_ops, "CONV_PATH", "pallas")
    with phase("policy rollouts, conv kernels"):
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            fn = make(amp)
            with conv_path():
                rollout(fn, params, diffusion.init_ring_carry(policy, N_ENVS),
                        stream, 5)                           # warm-up
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                a, _ = rollout(fn, params,
                               diffusion.init_ring_carry(policy, N_ENVS),
                               stream, N_FRAMES)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n = read_counts()
                # the plain path once more, holding K3-K5 against it on the
                # policy's own activations as it goes
                shadow = ShadowDoubleConv(cuda_ops)
                with mock.patch.object(cuda_ops, "double_conv", shadow), \
                        mock.patch.object(cuda_ops, "attention_core",
                                          cuda_ops.attention_core_ref):
                    rollout(fn, params,
                            diffusion.init_ring_carry(policy, N_ENVS),
                            stream, N_FRAMES)
                torch.cuda.synchronize()
            on_policy = shadow.summary()
            sp = spread(a, acts["fp32_plain"])
            runs[tag]["conv_path"] = dict(
                seconds=secs, fps=N_ENVS * N_FRAMES / secs, launches=n,
                kernels_on_policy=on_policy, vs_fp32_plain=sp)
            print(f"  {tag}, conv kernels: {N_ENVS * N_FRAMES} frames in "
                  f"{secs:.3f} s = {N_ENVS * N_FRAMES / secs:.1f} frames/s "
                  f"(default path {runs[tag]['fps']:.1f}); launches {n}",
                  flush=True)
            print(f"  {tag}, conv kernels vs plain on the policy's "
                  f"activations: {fmt(on_policy)}", flush=True)
            print(f"  {tag}, conv kernels, actions vs fp32 plain: {fmt(sp)}",
                  flush=True)
            if tuple(a.shape) != (N_FRAMES, N_ENVS, 3) or not bool(
                    torch.isfinite(a).all()):
                raise Failed(f"{tag} conv kernels: actions {tuple(a.shape)}, "
                             "or not finite")
            if any(n[k] != v for k, v in want_n.items()) or n["K2"]:
                raise Failed(f"{tag} conv kernels: launches {n}, expected "
                             f"{want_n} and no K2")
            if shadow.shapes != set(DC_SHAPES) or \
                    shadow.calls != want_n["K5"]:
                raise Failed(f"{tag}: the policy's DoubleConvs "
                             f"{sorted(shadow.shapes)} x {shadow.calls} are "
                             "not DC_SHAPES x 1500")
            dtype = torch.bfloat16 if amp else torch.float32
            for k, tol in (("K3", CONV_TOL), ("K4", CONV_TOL),
                           ("K5", DC_TOL)):
                if not on_policy[f"{k}_max_rel_err"] <= tol[dtype]:
                    raise Failed(f"{tag}: {k} differs from its plain version"
                                 f" on the policy's activations by "
                                 f"{on_policy[f'{k}_max_rel_err']} of the "
                                 f"largest output > {tol[dtype]}")
            if amp:
                if not (sp["mean"] <= AMP_MEAN_TOL
                        and sp["share_over"] <= AMP_SHARE_TOL):
                    raise Failed(f"amp conv kernels: actions too far from "
                                 f"the fp32 plain path: {sp}")
            elif not sp["max"] <= ACTION_TOL:
                raise Failed(f"fp32 conv kernels: actions differ from the "
                             f"plain path by {sp['max']} > {ACTION_TOL}")

    loop_bank = load_or_build_bank(LOOP_TRACKS, bake=True, device=device)
    loop_ids = torch.arange(N_ENVS, dtype=torch.int32,
                            device=device) % LOOP_TRACKS

    def drive(amp, n_frames, seed, warmup=0):
        fn = diffusion.make_ring_policy(
            policy, stats, sampler="ddim", num_inference_steps=10, amp=amp,
            seed=seed, warmup=warmup)
        states, _, out = vector.rollout_policy(
            loop_bank, diffusion.env_policy(fn, params),
            diffusion.init_ring_carry(policy, N_ENVS), n_frames,
            auto_reset=False, track_ids=loop_ids, device=device)
        return states, out

    loop = {}
    with phase("closed loop"):
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            drive(amp, 5, args.seed)                          # warm-up
            torch.cuda.synchronize()
            # the main path: counts to 0 just before, read just after
            zero_counts()
            t0 = time.perf_counter()
            states, out = drive(amp, N_FRAMES, args.seed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k1_n = cuda_ops.attention_core.launches
            k2_n = cuda_sampler.sample_banked.launches
            if any(read_counts()[k] for k in ("K3", "K4", "K5")):
                raise Failed(f"{tag} closed loop: conv kernels ran on the "
                             f"default conv path: {read_counts()}")
            loop[tag] = dict(seconds=secs, fps=N_ENVS * N_FRAMES / secs,
                             k1_launches=k1_n, k2_launches=k2_n,
                             actions=out.actions,
                             tiles=states.tile_count.float().mean().item())
            print(f"  {tag}: r5blend drives {N_ENVS} envs x {N_FRAMES} "
                  f"frames on the {LOOP_TRACKS}-track bank in {secs:.3f} s "
                  f"= {loop[tag]['fps']:.1f} frames/s; K1 launches {k1_n}, "
                  f"K2 launches {k2_n}", flush=True)
            if k1_n != 5 * 10 * denoises or k2_n != N_FRAMES + 1:
                raise Failed(f"{tag} closed loop: K1 {k1_n} (want "
                             f"{5 * 10 * denoises}), K2 {k2_n} (want "
                             f"{N_FRAMES + 1}) launches")
            a = out.actions
            if tuple(a.shape) != (N_FRAMES, N_ENVS, 3) or not bool(
                    torch.isfinite(a).all()):
                raise Failed(f"{tag} closed loop: actions {tuple(a.shape)}, "
                             "or not finite")
        # the same fp32 loop on the plain path: K1 and K2 plain versions
        with mock.patch.object(cuda_ops, "attention_core",
                               cuda_ops.attention_core_ref), \
                mock.patch.object(cuda_sampler, "sample_banked",
                                  cuda_sampler.sample_banked_ref):
            _, plain = drive(False, N_FRAMES, args.seed)
        d = (loop["fp32"]["actions"] - plain.actions).abs().max().item()
        loop["fp32"]["vs_plain_max"] = d
        print(f"  fp32 kernel path vs plain path over {N_FRAMES} frames: "
              f"max action diff {d:.3e} (tol {ACTION_TOL})")
        if not d <= ACTION_TOL:
            raise Failed(f"fp32 closed loop differs from the plain path by "
                         f"{d}")
        sp = spread(loop["amp"]["actions"], loop["fp32"]["actions"])
        loop["amp"]["vs_fp32"] = sp
        print(f"  amp vs fp32 closed loop (not held: chaotic): {fmt(sp)}")

        # driving metrics as the bench reads them: warm-up frames at a
        # straight action fill the rings, then the policy drives
        ring = policy.config.obs_horizon * policy.config.step_size
        t0 = time.perf_counter()
        states, out = drive(True, DRIVE_FRAMES, args.seed + 1, warmup=ring)
        sim_min = DRIVE_FRAMES / 3000.0
        loop["drive"] = dict(
            frames=DRIVE_FRAMES, seconds=time.perf_counter() - t0,
            tiles_per_sim_minute=states.tile_count.float().mean().item()
            / sim_min,
            reward_per_sim_minute=out.reward_alive.mean().item() / sim_min,
            done_fraction=states.done.float().mean().item())
        print(f"  amp, {N_ENVS} envs x {DRIVE_FRAMES} frames ({ring} "
              f"warm-up): {fmt(loop['drive'])}")

    with phase("closed loop, conv kernels"):
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            with conv_path():
                drive(amp, 5, args.seed)                      # warm-up
                torch.cuda.synchronize()
                # the conv-kernel path: counts to 0 just before, read after
                zero_counts()
                t0 = time.perf_counter()
                states, out = drive(amp, N_FRAMES, args.seed)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n = read_counts()
            a = out.actions
            loop[tag]["conv_path"] = dict(
                seconds=secs, fps=N_ENVS * N_FRAMES / secs, launches=n,
                tiles=states.tile_count.float().mean().item(),
                vs_plain=spread(a, plain.actions))
            print(f"  {tag}, conv kernels: {N_ENVS} envs x {N_FRAMES} frames "
                  f"in {secs:.3f} s = {N_ENVS * N_FRAMES / secs:.1f} frames/s"
                  f" (default path {loop[tag]['fps']:.1f}); launches {n}",
                  flush=True)
            print(f"  {tag}, conv kernels vs the all-plain fp32 path: "
                  f"{fmt(loop[tag]['conv_path']['vs_plain'])}", flush=True)
            if (any(n[k] != v for k, v in want_n.items())
                    or n["K2"] != N_FRAMES + 1):
                raise Failed(f"{tag} closed loop, conv kernels: launches {n},"
                             f" expected {want_n} and K2 {N_FRAMES + 1}")
            if tuple(a.shape) != (N_FRAMES, N_ENVS, 3) or not bool(
                    torch.isfinite(a).all()):
                raise Failed(f"{tag} closed loop, conv kernels: actions "
                             f"{tuple(a.shape)}, or not finite")
        d = loop["fp32"]["conv_path"]["vs_plain"]["max"]
        if not d <= ACTION_TOL:
            raise Failed(f"fp32 closed loop on the conv kernels differs from "
                         f"the all-plain path by {d} > {ACTION_TOL}")
        for v in loop.values():
            v.pop("actions", None)

    with phase("denoise timing"):
        window = {k: torch.randn((N_ENVS, 10, d), device=device)
                  for k, d in (("position", 2), ("velocity", 2),
                               ("action", 3), ("image_features", 128))}
        x_T = policy.init_noise(N_ENVS, torch.Generator().manual_seed(0))
        bf16_params = diffusion.policy.cast_params(params, torch.bfloat16)
        for amp in (False, True):
            tag = "amp" if amp else "fp32"
            for path in ("default", "conv_path"):
                with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"
                                       if path == "conv_path" else "xla9"):
                    ms = cuda_ms(lambda: policy.sample(
                        bf16_params if amp else params, window,
                        sampler="ddim", num_inference_steps=10, amp=amp,
                        init_noise=x_T), 5, warmup=2)
                if path == "default":
                    runs[tag]["denoise_ms"] = ms
                else:
                    runs[tag]["conv_path"]["denoise_ms"] = ms
                print(f"  DDIM-10 denoise, {N_ENVS} envs, {tag}, "
                      f"{path.replace('_', ' ')}: {ms:.3f} ms")
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with phase("card vs cpu"):
        small = 4
        cpu_policy, cpu_params, _ = load_run(RUN_DIR, "cpu")
        sub = tuple(t[:10, :small] for t in stream)
        fn_gpu = make(False)
        fn_cpu = diffusion.make_ring_policy(cpu_policy, stats, sampler="ddim",
                                            num_inference_steps=10,
                                            seed=args.seed)
        a_gpu, _ = rollout(fn_gpu, params,
                           diffusion.init_ring_carry(policy, small), sub, 10)
        a_cpu, _ = rollout(
            lambda p, c, o, x, v: fn_cpu(p, c, o.cpu(), x.cpu(), v.cpu()),
            cpu_params, diffusion.init_ring_carry(cpu_policy, small), sub, 10)
        d = (a_gpu.cpu() - a_cpu).abs().max().item()
        print(f"  {small} envs x 10 frames, card vs cpu: max action diff "
              f"{d:.3e} (tol {ACTION_TOL})")
        if not d <= ACTION_TOL:
            raise Failed(f"card and cpu actions differ by {d}")

    counts = (zero_counts, read_counts)
    with phase("r4rn serve"):
        r4rn = r4rn_serve_phase(args, cuda_ops, device, counts)

    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        with phase("collect"):
            store, collected = collect_phase(device, work, counts, smi)
        with phase("codecs"):
            codecs = codecs_phase(store, work, smi)
        training = train_phases(args, device, cuda_ops, policy, params, stats,
                                counts, work)
        with phase("multi-device"):
            multi = multi_device_phase(args, device, smi, work)
        with phase("zstd"):
            zst = zstd_phase(counts, smi)
        with phase("eval"):
            evaluated = eval_phase(device, work, counts, cuda_ops)
        r4rn["training"] = r4rn_train_phase(args, cuda_ops, device, counts,
                                            work)
        with phase("autoencoder"):
            autoencoder = autoencoder_phase(device, counts, work)
        with phase("native"):
            native_run = native_phase(work)
        with phase("sample"):
            sampled = sample_phase(device, work, counts, cuda_ops, args.seed)
        with phase("run_predictions"):
            demo = run_predictions_phase(device, work, counts, args.seed)
        with phase("mfu"):
            mfu_run = mfu_phase(device, counts, cuda_ops, smi)
        with phase("profile"):
            profiled = profile_phase(device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    fp32 = [r for r in k1 if r["dtype"] == "float32" and r["r5blend"]]
    # the five calls are separate launches: the forward's bound is the sum
    # of each call's own, labelled by the side that sets most of that sum
    fwd_bound_ms = sum(r["bound_ms"] for r in fp32)
    by_side = {side: sum(r["bound_ms"] for r in fp32 if r["bound_by"] == side)
               for side in ("bytes", "operations")}
    fwd_bound_by = max(by_side, key=by_side.get)
    kernels = [{
        "name": "attention_core",
        "route": "cuda",
        "source": "state_policy_diffusionmodel_torch/csrc/attention_core.cu",
        "replaces": "state_policy_diffusionmodel_tpu/models/pallas_ops.py:611",
        # the closed loop's fp32 run (the observation-fed rollout reads
        # the same 500); the eval phase's beside it
        "launches": loop["fp32"]["k1_launches"],
        "launches_eval": evaluated["launches"]["K1"],
        "launches_r4rn": r4rn["closed_loop"]["fp32"]["launches"]["K1"],
        # cli/sample.py's DDPM (1,000 forwards at B=1), cli/run_predictions'
        # two runs, cli/mfu.py's forward row (default path)
        "launches_sample_ddpm": sampled["DDPM-1000"]["launches"]["K1"],
        "launches_run_predictions": demo["pid"]["launches"]["K1"]
        + demo["policy"]["launches"]["K1"],
        "launches_mfu": mfu_run["forward, default path"]["launches"]["K1"],
        # each rank's, two gloo ranks on the card (128 envs, 20 frames)
        "launches_sharded_loop": [r["K1"] for r in
                                  multi["gloo_2_ranks_one_card"]],
        "launches_shared_accuracy": zst["launches"]["K1"],
        # one U-Net forward's five calls at B=256, fp32 (the main path)
        "max_abs_err": max(r["max_abs_err"] for r in fp32),
        "max_abs_err_on_policy": runs["fp32"]["k1_on_policy"]["max_abs_err"],
        "ms": sum(r["ms"] for r in fp32),
        "plain_ms": sum(r["plain_ms"] for r in fp32),
        "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by,
        "library_ms": sum(r["library_ms"] for r in fp32),
        # the bound's three terms and the earlier two-term bound, summed
        **{k: sum(r[k] for r in fp32)
           for k in ("byte_ms", "op_ms", "exp_ms", "bound_ms_two_term")},
        # the same five calls in bf16 (amp's forward), summed likewise
        "bf16": per_forward(k1, ATTN_SHAPES, lambda r: (r["T"], r["C"]),
                            "bfloat16"),
        "ptxas": k1_ptxas,
        # forwards off r5blend's path: width 128, a 48x8 input
        "unets": k1_unets,
        # the backward is plain torch, as JAX's VJP is plain XLA
        "backward": "plain torch (attention_core_bwd)",
        "backward_ms": k1_bwd_ms,
        "per_call": k1,
    }]
    # K2 at the env bench's batch on the env's own poses; every case in
    # per_case
    k2_main = next(r for r in k2 if r["case"] == "env poses after 50 steps")
    kernels.append({
        "name": "sample_banked",
        "route": "cuda",
        "source": "state_policy_diffusionmodel_torch/csrc/sample_banked.cu",
        "replaces": "state_policy_diffusionmodel_tpu/render/pallas_sampler.py"
                    ":137",
        "launches": loop["fp32"]["k2_launches"],
        "launches_env_render": envs_run["env_render"]["k2_launches"],
        "launches_collect": collected["launches"]["K2"],
        "launches_r4rn": r4rn["closed_loop"]["fp32"]["launches"]["K2"],
        "launches_run_predictions": demo["pid"]["launches"]["K2"]
        + demo["policy"]["launches"]["K2"],
        "launches_sharded_loop": [r["K2"] for r in
                                  multi["gloo_2_ranks_one_card"]],
        "max_abs_err": max(r["max_abs_err"] for r in k2),
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": None,
        "ptxas": k2_ptxas,
        "per_case": k2,
    })
    kernels += conv_kernel_entries(k3, k4, k5, runs, loop)
    # UNetSimple's forward (width 16, B=256) and r4rn's conv-path loop
    r4rn_conv = r4rn["closed_loop"]["fp32, conv kernels"]["launches"]
    for name, k, recs, calls, key in (
            ("conv3x3", "K3", k3_simple, conv_calls(SIMPLE_DC_SHAPES),
             lambda r: (r["H"], r["W"], r["Cin"], r["Cout"])),
            ("gn_act", "K4", k4_simple, gn_calls(SIMPLE_DC_SHAPES),
             lambda r: (r["H"], r["W"], r["C"], r["variant"])),
            ("double_conv", "K5", k5_simple, SIMPLE_DC_SHAPES,
             lambda r: (r["H"], r["W"], r["Cin"], r["Cout"],
                        r["residual"]))):
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches_r4rn"] = r4rn_conv[k]
        entry["launches_mfu"] = mfu_run["forward, conv kernels"][
            "launches"][k]
        entry["launches_unet_simple"] = simple["fp32"]["launches"][k]
        entry["unet_simple"] = dict(
            fp32=per_forward(recs, calls, key),
            bf16=per_forward(recs, calls, key, "bfloat16"),
            max_rel_err_on_net=simple["fp32"]["kernels_on_net"][
                f"{k}_max_rel_err"],
            per_shape=recs)
    next(k for k in kernels if k["name"] == "conv3x3")["ptxas"] = k3_ptxas
    next(k for k in kernels if k["name"] == "gn_act")["ptxas"] = k4_ptxas
    dw_key = lambda r: (r["H"], r["W"], r["Cin"], r["Cout"])
    step = per_forward(k6, TRAIN_CONVS, dw_key)
    step_bf16 = per_forward(k6, TRAIN_CONVS, dw_key, "bfloat16")
    kernels.append({
        "name": "conv_dw", "route": "cuda",
        "source": "state_policy_diffusionmodel_torch/csrc/conv_dw.cu",
        "replaces": "state_policy_diffusionmodel_tpu/models/pallas_ops.py"
                    ":262",
        # one fp32 training step on SPDM_CONV_BWD=pallas
        "launches": training["gradients"]["conv_bwd"]["fp32"]["launches"][
            "K6"],
        "max_abs_err": step["max_abs_err"], "ms": step["ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_ms_9taps": step["bound_ms_9taps"],
        "bound_ms_taps_computed": step["bound_ms_taps_computed"],
        "bound_by": step["bound_by"], "library_ms": step["library_ms"],
        "launches_r4rn": r4rn["training"]["gradients"]["conv_bwd"]["fp32"][
            "launches"]["K6"],
        "bf16": step_bf16, "ptxas": k6_ptxas, "per_shape": k6})
    print(json.dumps({"kernels": kernels, "policy": runs, "env": envs_run,
                      "closed_loop": loop, "collect": collected,
                      "training": training, "eval": evaluated,
                      "unet_simple": simple, "r4rn": r4rn,
                      "autoencoder": autoencoder, "native": native_run,
                      "sample": sampled, "run_predictions": demo,
                      "mfu": mfu_run, "profile": profiled,
                      "multi_device": multi, "zstd": zst,
                      "codecs": codecs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
