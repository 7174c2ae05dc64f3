"""The roofline and FLOP arithmetic against hand counts at small shapes."""

import types

import pytest
import torch

from perfbench import flops, readers, trace

OPS = trace.roofline_ops()


def test_attention_work_by_hand():
    att = OPS["attention"]
    q = torch.zeros((2, 30, 64))
    call = att.describe(q, q, q, num_heads=4)
    # two products of (30 x 16) by (16 x 30) and (30 x 30) by (30 x 16),
    # 2 * 30 * 30 * 16 operations each, for 4 heads and 2 rows of the batch
    assert att.work(call) == (2 * 4 * 2 * (2 * 30 * 30 * 16),
                              4 * 2 * 30 * 64 * 4, "fp32")
    assert not att.takes(call)                 # a CPU call: no kernel
    call["cuda"] = True
    assert att.takes(call)
    assert not att.takes(dict(call, T=7))      # the plain path's
    bf = dict(call, dtype="bfloat16")
    assert att.work(bf)[1:] == (4 * 2 * 30 * 64 * 2, "bf16")


def test_texel_gather_work_by_hand():
    tg = OPS["texel_gather"]
    rx = torch.zeros((72, 128))
    call = tg.describe(torch.zeros((2, 8, 8), dtype=torch.uint8),
                       torch.zeros((3,), dtype=torch.int32), None, None,
                       None, rx, rx)
    P = 72 * 128
    # a texel byte and an int32 out a pixel, two float32 planes, each env's
    # cos, sin, 2-vector position and id
    assert tg.work(call) == (0, 3 * P * 5 + 2 * P * 4 + 3 * 20, "fp32")


def fake_run(calls, kernels_ns, peaks):
    prof = trace.Profile()
    prof.calls = {"attention": calls}
    prof.device = [("attention_core_kernel<float>", i * 10, d)
                   for i, d in enumerate(kernels_ns)]
    return types.SimpleNamespace(profile=prof, peaks=peaks)


def test_roofline_share_by_hand():
    peaks = {"fp32": 1e12, "bf16": 4e12, "bytes_per_s": 1e8}
    call = {"B": 1, "T": 16, "C": 8, "heads": 1, "dtype": "float32",
            "cuda": True}
    flops_, nbytes, _ = OPS["attention"].work(call)
    assert (flops_, nbytes) == (4 * 16 * 16 * 8, 4 * 16 * 8 * 4)
    # bound a call: max(8192 / 1e12, 2048 / 1e8) = 20,480 ns; the kernels
    # take 40,960 ns each
    run = fake_run([call, call], [40960, 40960], peaks)
    assert readers.roofline(run, "attention") == pytest.approx(50.0)
    # a kernel with no call (or a call with none) is not paired: nothing
    assert readers.roofline(fake_run([call], [1, 1], peaks),
                            "attention") is None
    assert readers.roofline(fake_run([dict(call, T=4)], [1], peaks),
                            "attention") is None


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 5, 3, padding=1)
        self.fc = torch.nn.Linear(7, 11)

    def forward(self, x, v):
        return self.conv(x).sum() + self.fc(v).sum()


def test_flop_split_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    m = Tiny()
    c = FlopCounterMode(display=False)
    with c:
        m(torch.zeros((2, 3, 6, 4)), torch.zeros((4, 7)))
    got = flops._split(c)
    assert got == {"conv": 2 * 2 * 5 * 6 * 4 * 3 * 9,
                   "matmul": 2 * 4 * 7 * 11}


def test_mfu_by_hand():
    counts = flops.Counts({"conv": 6e9, "matmul": 1e9},
                          {"conv": 0.0, "matmul": 2e9})
    run = types.SimpleNamespace(
        trace=True, flops=counts, peaks={"fp32": 1e12, "tf32": 6e12},
        precision={"conv": "tf32", "matmul": "fp32"},
        spans={"frame": [1.0, 5.0, 5.0, 10.0]},
        marks={"replan": [True, True, False, False]}, traced_units=1)
    run.untraced = lambda n: run.spans[n][2:]
    run.untraced_marks = lambda n: run.marks[n][2:]
    # two plain units: 2 * (6e9 / 6e12 + 1e9 / 1e12) = 4 ms of 15 ms
    assert readers.mfu(run, "frame") == pytest.approx(100 * 4 / 15)


def test_drive_counts_scale_with_the_batch():
    conf = {"policy": {"obs_horizon": 10, "pred_horizon": 30,
                       "model": "UNet_Film", "model_width": 8,
                       "vision_encoder": "autoencoder", "step_size": 5}}
    one = flops.unit_counts(conf, {"generator": "drive", "envs": 1,
                                   "inference_steps": 10})
    four = flops.unit_counts(conf, {"generator": "drive", "envs": 4,
                                    "inference_steps": 10})
    assert four.unit(True)["conv"] == pytest.approx(4 * one.unit(True)["conv"])
    assert one.unit(True)["matmul"] > one.unit(False)["matmul"] > 0
