"""The port's tracing and timing utilities (`utils/profiling.py`) and the
training CLI's --tensorboard and --profile_dir, on CPU.

`StepTimer` and `timed` report what the JAX package's do (the same keys
and counts); `trace` writes a Chrome trace whose events name the
operators run inside it; --tensorboard mirrors the trainer's scalars into
an event file under the JAX trainer's tags where the tensorboard package
imports, and says once that they go to metrics.jsonl only where it does
not; --profile_dir runs one tiny epoch (width 8, obs 4 / pred 6 / step 2)
under `trace` and leaves its trace in the directory.
"""

import builtins
import json
import os

import pytest
import torch

from state_policy_diffusionmodel_tpu.utils import profiling as jprof
from state_policy_diffusionmodel_torch.cli import train_policy as tcli
from state_policy_diffusionmodel_torch.utils import profiling

from test_torch_cli_sample import write_episodes
from test_torch_policy import torch_threads

_torch_threads = torch_threads(2)

TINY = ["--obs_horizon", "4", "--pred_horizon", "6", "--step_size", "2",
        "--model_width", "8", "--batch_size", "8", "--n_epochs", "1",
        "--no_early_stop", "--no_sample_viz", "--device", "cpu"]


def test_step_timer_and_timed_match_jax():
    got, want = profiling.StepTimer(), jprof.StepTimer()
    for n in (3, 5, 8):
        got.tick(n)
        want.tick(n)
    a, b = got.snapshot(), want.snapshot()
    assert set(a) == set(b)
    assert (a["steps"], got.items) == (b["steps"], want.items) == (3, 16)
    assert a["items_per_sec"] == pytest.approx(16 / a["seconds"])
    got.reset()
    assert got.steps == got.items == 0
    logged = []
    with profiling.timed("phase", log=logged.append) as t:
        torch.ones(4).sum()
    assert t.seconds >= 0 and logged == [
        {"event": "timing", "name": "phase", "seconds": t.seconds}]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).relu_()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu_" in names


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("prof")
    write_episodes(root / "ds.zarr", lengths=(34, 30))
    return root


def _args(store, out, *extra):
    return ["--dataset_dir", str(store), "--dataset_name", "ds.zarr",
            "--out_dir", str(out), "--version", "v", *TINY, *extra]


def test_tensorboard_writes_event_file(store, tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tcli.main(_args(store, tmp_path, "--tensorboard"))
    run = tmp_path / "v"
    events = list(run.glob("events.out.tfevents.*"))
    assert events
    acc = EventAccumulator(str(run), purge_orphaned_data=False)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"val_loss", "lr", "epoch_train_loss", "steps_per_sec"} <= tags
    # every record of metrics.jsonl that holds a val_loss, in order
    with open(run / "metrics.jsonl") as f:
        vals = [r["val_loss"] for r in map(json.loads, f) if "val_loss" in r]
    got = [e.value for e in acc.Scalars("val_loss")]
    assert got == pytest.approx(vals, rel=1e-6)


def test_tensorboard_missing_is_said_once(store, tmp_path, monkeypatch,
                                          capsys):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)
    res = tcli.main(_args(store, tmp_path, "--tensorboard"))
    assert res["step"] >= 1
    said = [line for line in capsys.readouterr().out.splitlines()
            if "package" in line]
    assert said == ["--tensorboard: the tensorboard package is not "
                    "installed here; scalars go to metrics.jsonl only"]
    assert not list((tmp_path / "v").glob("events.out.tfevents.*"))


def test_profile_dir_traces_one_epoch(store, tmp_path):
    prof = tmp_path / "prof"
    res = tcli.main(_args(store, tmp_path, "--profile_dir", str(prof)))
    assert res["step"] >= 1
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the U-Net's convs and the optimizer ran inside the trace
    assert "aten::convolution" in names
    assert any(n and n.startswith("Optimizer.step") for n in names)
    assert (tmp_path / "v" / "checkpoints" / "epoch=0").is_dir()
