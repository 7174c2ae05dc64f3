"""Whole runs on the CPU at small sizes (the look for a card skipped; the
port's kernels take their plain versions on CPU tensors), sound and with
the timed path broken underneath: `correct` has to come out true for the
sound runs and false for every fault a cell can have."""

import time

import pytest
import torch

from perfbench import harness
from state_policy_diffusionmodel_torch.diffusion import policy as P
from state_policy_diffusionmodel_torch.envs import car_racing
from state_policy_diffusionmodel_torch.train import loop

DRIVE = {"envs": 6, "tracks": 2, "warmup_frames": 6, "check_within": 12,
         "check_replans": 1, "check_frames": 1, "trace_frames": 3}
SMALL = {
    "r5blend.drive": DRIVE,
    "train": {"batch": 8, "episodes": 2, "frames": 230, "batch_pool": 40,
              "warmup_steps": 4, "trace_steps": 2},
}


def result(capsys, cell, seconds="8", trace="0", control=False):
    sizes = SMALL.get(cell, SMALL["train"])
    rc = harness.main(["--workload", cell, "--seed", "2718281828",
                       "--seconds", seconds, "--trace", trace],
                      time.monotonic(), "cpu",
                      {"sizes": sizes, "control": control})
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    import json

    return json.loads(out[-1])


@pytest.mark.parametrize("cell", ["r5blend.drive", "r4rn.train"])
def test_sound_run_is_correct(capsys, cell):
    res = result(capsys, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0


def test_traced_run_reports_per_layer(capsys):
    res = result(capsys, "r5blend.drive", trace="1")
    assert res["correct"]
    assert "replan_ms.drive" in res["metrics"]
    assert "frames_per_s" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_drive_state_left_unchanged(capsys, monkeypatch):
    real = car_racing.step

    def step(state, *args, **kwargs):
        _, res = real(state, *args, **kwargs)
        return state, res

    monkeypatch.setattr(car_racing, "step", step)
    res = result(capsys, "r5blend.drive")
    assert not res["correct"]
    assert res["checks"]["obs_gap"]["value"] > \
        res["checks"]["obs_gap"]["limit"]


def test_drive_answer_altered(capsys, monkeypatch):
    real = P.DiffusionPolicy.sample

    def sample(self, *args, **kwargs):
        return real(self, *args, **kwargs) + 0.05

    monkeypatch.setattr(P.DiffusionPolicy, "sample", sample)
    res = result(capsys, "r5blend.drive")
    assert not res["correct"]
    assert res["checks"]["action_gap"]["value"] > \
        res["checks"]["action_gap"]["limit"]


@pytest.mark.parametrize("cell", ["r4rn.train"])
def test_train_state_left_unchanged(capsys, monkeypatch, cell):
    monkeypatch.setattr(loop.Optimizer, "step", lambda self, lr: None)
    res = result(capsys, cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["r4rn.train"])
def test_train_half_batch(capsys, monkeypatch, cell):
    real = P.DiffusionPolicy.loss

    def loss(self, params, batch, generator=None, t=None, noise=None):
        h = next(iter(batch.values())).shape[0] // 2
        return real(self, params, {k: v[:h] for k, v in batch.items()},
                    generator, t=t[:h], noise=noise[:h])

    monkeypatch.setattr(P.DiffusionPolicy, "loss", loss)
    res = result(capsys, cell)
    assert not res["correct"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "r5blend.drive", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], time.monotonic())
    assert rc != 0 and capsys.readouterr().out == ""


def test_jax_loaded_no_result(capsys, monkeypatch):
    import types

    monkeypatch.setattr(harness, "run", lambda *a: {"checks": {}})
    monkeypatch.setitem(__import__("sys").modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    rc = harness.main(["--workload", "r5blend.drive", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], time.monotonic())
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jaxlib" in captured.err
