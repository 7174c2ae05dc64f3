"""The port's trainer on CPU: the lr schedules against the JAX package's,
the hparams text, a tiny `Trainer.fit` with resume, and the training CLI.

Policies run at model_width=8 with the r5blend horizons on synthetic
episodes (96x96 uint8 frames) written as zarr stores; nothing here
compiles JAX. Schedules and the hparams round trip are exact.
"""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml

from state_policy_diffusionmodel_tpu.train import loop as jl
from state_policy_diffusionmodel_tpu.train import lr_schedule as jlr
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch import train as tt
from state_policy_diffusionmodel_torch.cli import train_policy as tcli
from state_policy_diffusionmodel_torch.data import ReplayBuffer, save_zarr
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.params_from_jax import params_to_jax
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.train import loop as tl

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "artifacts" / "r5blend_best"
CFG = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="autoencoder",
           step_size=5, model_width=8)
LR, DECAY = 4e-4, 0.9995


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work: pytest-xdist runs
    several test processes on the host's cores, and oversubscribed OpenMP
    pools spin (a fit here measured >10x slower with the default count
    than alone); the checks do not depend on the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# lr schedules
# ---------------------------------------------------------------------------

def test_lr_schedules_match():
    rng = np.random.default_rng(1)
    metrics = list(rng.uniform(0.5, 1.0, 40)) + [0.4] + [0.45] * 12
    for kw in ({}, dict(min_lr=1e-5, patience=2), dict(factor=0.5)):
        a, b = (tt.ReduceLROnPlateau(lr=1e-3, **kw),
                jlr.ReduceLROnPlateau(lr=1e-3, **kw))
        for m in metrics:
            assert a.update(m) == b.update(m)
            assert (a.best, a.num_bad) == (b.best, b.num_bad)
    for lr in (1e-4, 9.99e-5, 1e-3, 0.0):
        assert tt.should_early_stop(lr) == jlr.should_early_stop(lr)
    for kw in (dict(epochs=90, lr=4e-4, min_lr=1e-6), dict(epochs=1),
               dict(epochs=0, lr=1e-3)):
        tc, jc = tl.TrainConfig(**kw), jl.TrainConfig(**kw)
        for e in range(-1, 95):
            assert tl._cosine_lr(tc, e) == jl._cosine_lr(jc, e)
    assert dataclasses.asdict(tl.TrainConfig()) == dataclasses.asdict(
        jl.TrainConfig())


def test_hparams_of_r5blend_round_trip():
    """r5blend's hparams.yaml (written by yaml.safe_dump) parses in the port
    and is written back as the same text."""
    text = (RUN_DIR / "hparams.yaml").read_text()
    hp = tck.load_hparams(str(RUN_DIR / "hparams.yaml"))
    assert hp == yaml.safe_load(text)
    assert "".join(f"{k}: {tck.yaml_scalar(hp[k])}\n"
                   for k in sorted(hp)) == text


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------

def _episodes(path, seed=0, lengths=(230, 245, 220)):
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer()
    for L in lengths:
        buf.add_episode({
            "img": rng.integers(0, 256, (L, 96, 96, 3), dtype=np.uint8),
            "position": np.cumsum(rng.normal(size=(L, 2)), 0)
            .astype(np.float32),
            "velocity": rng.normal(size=(L, 2)).astype(np.float32),
            "action": rng.uniform(-1, 1, (L, 3)).astype(np.float32)})
    save_zarr(buf, path)
    return buf


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("device_data", [True, False])
def test_trainer_fit_writes_the_run_dir_and_resumes(tmp_path, device_data):
    _episodes(str(tmp_path / "ds.zarr"))
    dm = tds.DataModule(batch_size=16, data_dir=str(tmp_path), T_obs=10,
                        T_pred=30, seed=42, step_size=5)
    dm.setup("ds.zarr")
    pol = td.DiffusionPolicy(td.PolicyConfig(**CFG), device="cpu")
    out, ins = str(tmp_path / "run"), str(tmp_path / "ins")
    cfg = tl.TrainConfig(epochs=2, batch_size=16, lr=LR, min_lr=1e-6,
                         lr_schedule="cosine", ema_decay=DECAY,
                         device_data=device_data, early_stop=False,
                         insurance_dir=ins)
    res = tl.Trainer(pol, cfg, out).fit(dm)
    n_batches = len(dm.train_idx) // 16
    assert res["step"] == 2 * n_batches
    assert all(np.isfinite(res["history"]["train_loss"]))
    for p in ("checkpoints/epoch=0/params.npz",
              "checkpoints/epoch=1/params.npz",
              "checkpoints_ema/epoch=1/params.npz", "STATS.pkl",
              "hparams.yaml", "metrics.jsonl", "trainer_state/meta.yaml",
              "trainer_state/opt/params.npz"):
        assert os.path.exists(os.path.join(out, p)), p
    with open(os.path.join(ins, "BEST.json")) as f:
        best = json.load(f)
    assert best["ema"] is True
    with np.load(os.path.join(ins, "checkpoints", f"epoch={best['epoch']}",
                              "params.npz")) as z:
        assert all(z[k].dtype == np.float16 for k in z.files)
    kinds = [e["event"] for e in _events(out)]
    assert kinds[0] == "pre_val" and kinds.count("epoch") == 2
    assert kinds.count("val") == 2 * (n_batches // max(1, n_batches // 4))
    # the EMA run dir serves: load_run(ema=True) gives a working policy
    pol2, params, _ = tck.load_run(out, "cpu", ema=True)
    assert params["unet"].width == 8

    res = tl.Trainer(pol, dataclasses.replace(cfg, epochs=3), out).fit(
        dm, resume=True)
    assert res["step"] == 3 * n_batches
    resumed = [e for e in _events(out) if e["event"] == "resume"]
    assert resumed == [dict(resumed[0], epoch=2, step=2 * n_batches)]
    assert os.path.exists(os.path.join(out, "checkpoints", "epoch=2"))


def test_cli_trains_on_cpu_and_refuses_what_is_not_ported(tmp_path):
    _episodes(str(tmp_path / "ds.zarr"), seed=1, lengths=(240, 236))
    args = ["--dataset_dir", str(tmp_path), "--dataset_name", "ds.zarr",
            "--out_dir", str(tmp_path / "runs"), "--version", "v",
            "--batch_size", "16", "--n_epochs", "1", "--model_width", "8",
            "--lr", "4e-4", "--lr_schedule", "cosine", "--min_lr", "1e-6",
            "--ema_decay", "0.9995", "--device_data", "--no_early_stop",
            "--device", "cpu"]
    for extra, what in ((["--tensorboard"], "TensorBoard"),
                        (["--model", "UNet"], "UNetSimple"),
                        (["--vision_encoder", "resnet18"], "ResNet18GN"),
                        (["--profile_dir", "p"], "profile")):
        with pytest.raises(NotImplementedError, match=what):
            tcli.main(args + ["--no_sample_viz"] + extra)
    with pytest.raises(NotImplementedError, match="--no_sample_viz"):
        tcli.main(args)
    res = tcli.main(args + ["--no_sample_viz"])
    run = tmp_path / "runs" / "v"
    assert res["step"] >= 1
    for p in ("checkpoints/epoch=0", "checkpoints_ema/epoch=0", "STATS.pkl",
              "hparams.yaml", "metrics.jsonl"):
        assert (run / p).exists(), p
    hp = tck.load_hparams(str(run / "hparams.yaml"))
    assert (hp["model_width"], hp["train_lr"], hp["train_ema_decay"],
            hp["train_device_data"]) == (8, 4e-4, 0.9995, True)
    # an autoencoder checkpoint's encoder goes in through the bridge
    ae = tmp_path / "ae" / "checkpoints" / "epoch=2"
    enc = td.DiffusionPolicy(td.PolicyConfig(**CFG), "cpu").init_params(
        torch.Generator().manual_seed(9))["encoder"]
    leaves = params_to_jax({"encoder": enc})
    leaves["['decoder']['Dense_0']['kernel']"] = np.zeros((128, 4),
                                                          np.float32)
    ae.mkdir(parents=True)
    np.savez(ae / "params.npz", **leaves)
    path, tree = tcli.load_encoder_tree(str(tmp_path / "ae"))
    assert path.endswith("epoch=2")
    got = params_to_jax({"encoder": td.DiffusionPolicy(
        td.PolicyConfig(**CFG), "cpu").init_params(
            torch.Generator(), encoder_params=tree)["encoder"]})
    for k, v in got.items():
        np.testing.assert_array_equal(v, leaves[k])
