"""The port's trainer on CPU: the lr schedules against the JAX package's,
the hparams text, a tiny `Trainer.fit` with resume, and the training CLI.

Policies run at model_width=8 with the r5blend horizons on synthetic
episodes (96x96 uint8 frames) written as zarr stores; nothing here
compiles JAX (the JAX package reads the CLI's ResNet18-GN and UNetSimple
runs through `jax.eval_shape` and its npz loader). Schedules and the
hparams round trip are exact.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
from unittest import mock

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

from test_torch_policy import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "artifacts" / "r5blend_best"
CFG = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="autoencoder",
           step_size=5, model_width=8)
LR, DECAY = 4e-4, 0.9995


_torch_threads = torch_threads(2)


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
    # the sample figures are on by default; without matplotlib (the GPU
    # machine) the CLI raises and names the flag that turns them off
    find_spec = importlib.util.find_spec
    with mock.patch.object(importlib.util, "find_spec", lambda name, *a: (
            None if name == "matplotlib" else find_spec(name, *a))):
        with pytest.raises(RuntimeError, match="--no_sample_viz"):
            tcli.main(args)
    # --tensorboard is ported: the scalars also go to an event file where
    # the tensorboard package imports (the CPU container has it)
    res = tcli.main(args + ["--no_sample_viz", "--tensorboard"])
    run = tmp_path / "runs" / "v"
    assert res["step"] >= 1
    if importlib.util.find_spec("tensorboard") is not None:
        assert list(run.glob("events.out.tfevents.*"))
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


@pytest.mark.parametrize("extra,net,encoder", [
    (["--vision_encoder", "resnet18", "--train_encoder"], "UNetFiLM",
     "ResNet18GN"),
    (["--model", "UNet"], "UNetSimple", "Encoder")])
def test_cli_trains_resnet_and_unet_simple_runs_both_packages_load(
        tmp_path, extra, net, encoder):
    """One epoch through the CLI with a trained ResNet18GN encoder, and
    with UNetSimple (short horizons, batch 4, so a CPU epoch is a few
    steps); the run loads strictly through the port's load_run, and the
    JAX package reads its hparams and every leaf of its checkpoint."""
    import jax

    from state_policy_diffusionmodel_tpu import diffusion as jd
    from state_policy_diffusionmodel_tpu.train import checkpoints as jck

    _episodes(str(tmp_path / "ds.zarr"), seed=2, lengths=(40, 36))
    args = ["--dataset_dir", str(tmp_path), "--dataset_name", "ds.zarr",
            "--out_dir", str(tmp_path / "runs"), "--version", "v",
            "--batch_size", "4", "--n_epochs", "1", "--model_width", "8",
            "--obs_horizon", "2", "--pred_horizon", "6", "--step_size", "2",
            "--no_early_stop", "--no_sample_viz", "--device", "cpu"] + extra
    res = tcli.main(args)
    run = str(tmp_path / "runs" / "v")
    assert res["step"] >= 1
    assert np.isfinite([e["val_loss"] for e in _events(run)
                        if "val_loss" in e]).all()
    pol, params, _ = tck.load_run(run, "cpu")
    assert (type(params["unet"]).__name__,
            type(params["encoder"]).__name__) == (net, encoder)
    hp = jck.load_hparams(os.path.join(run, "hparams.yaml"))
    jcfg = jd.PolicyConfig(**{k: hp[k] for k in tck._CONFIG_KEYS})
    assert jcfg.observation_dim == pol.config.observation_dim
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        jd.DiffusionPolicy(jcfg).init_params, jax.random.key(0)))
    loaded = jck.load_checkpoint(tck.latest_checkpoint(run), like)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(loaded)[0]}
    mine = params_to_jax(params)
    assert sorted(flat) == sorted(mine)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    if "--train_encoder" in extra:
        # the encoder trained: its weights moved from the initial draw
        init = td.DiffusionPolicy(pol.config, "cpu").init_params(
            torch.Generator().manual_seed(42))["encoder"]
        assert any(not torch.equal(a, b) for a, b in zip(
            init.parameters(), params["encoder"].parameters()))
