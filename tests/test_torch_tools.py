"""The port's data and checkpoint tools (`state_policy_diffusionmodel_torch/
tools/`) against the JAX package's `tools/*.py`, on CPU, at tiny sizes.

- merge_datasets, snapshot_run and make_resume_sidecar are deterministic:
  on the same input each writes what the JAX tool writes (the same arrays,
  episode ends and meta; the same npz leaves, dtypes and sidecars; the
  same optimizer leaves and meta), and what they write is read by both
  packages (the snapshot as a run dir, the sidecar by `--resume` of the
  port's trainer and by the JAX package's `load_train_state`).
- make_shared_evalset collects on each package's env, which part by float32
  rounding: with 12 steps an episode, keys, shapes, dtypes, episode ends,
  `meta/track_seed` and `meta/driver_id` are equal, positions within 1e-3
  and frames within 30 of 27,648 bytes (tests/test_torch_collect.py's
  tolerances); each package reads the other's store.

The JAX snapshot tool restores a checkpoint without a template, as orbax
can; both packages' runs here are npz, whose restore needs one, so the
test hands it the template the JAX sidecar tool rebuilds from the same
npz. The JAX sidecar tool writes its optimizer state through orbax where
orbax imports: the test reads it back through the JAX package's
`load_train_state` and compares its keystr leaves.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.data import replay_buffer as trb
from state_policy_diffusionmodel_torch.tools import (
    make_resume_sidecar, make_shared_evalset, merge_datasets, snapshot_run,
)
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.train import loop as tl

from test_torch_policy import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(noise_steps=100, obs_horizon=2, pred_horizon=6, inpaint_horizon=1,
           model="UNet_Film", model_width=8, vision_encoder="autoencoder",
           step_size=1)
POS_ATOL, FRAME_BUDGET = 1e-3, 30

_torch_threads = torch_threads(2)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv):
    mod = _jax_tool(name)
    with mock.patch.object(sys, "argv", [name] + [str(a) for a in argv]):
        mod.main()
    return mod


def _episode(rng, n, keys):
    ep = {"img": rng.random((n, 96, 96, 3)).astype(np.float32),
          "position": rng.normal(size=(n, 2)).astype(np.float32),
          "velocity": rng.normal(size=(n, 2)).astype(np.float32),
          "action": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
          "car_state": rng.normal(size=(n, 30)).astype(np.float32)}
    return {k: v for k, v in ep.items() if k in keys}


def _assert_same_store(got, want):
    assert sorted(got.data) == sorted(want.data)
    for k, v in want.data.items():
        np.testing.assert_array_equal(np.asarray(got.data[k]), v, err_msg=k)
        assert np.asarray(got.data[k]).dtype == v.dtype
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert sorted(got.meta) == sorted(want.meta)
    for k, v in want.meta.items():
        np.testing.assert_array_equal(got.meta[k], v)


def test_merge_datasets_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    a, b = trb.ReplayBuffer(), trb.ReplayBuffer()
    every = ("img", "position", "velocity", "action", "car_state")
    for n in (7, 5):
        a.add_episode(_episode(rng, n, every))
    a.meta["track_seed"] = np.asarray([11, 12], np.int64)
    b.add_episode(_episode(rng, 6, every[:4]))   # no car_state, no seeds
    trb.save_zarr(a, str(tmp_path / "a.zarr"))
    trb.save_zarr(b, str(tmp_path / "b.zarr"))
    srcs = [tmp_path / "a.zarr", tmp_path / "b.zarr"]
    merge_datasets.main([tmp_path / "port.zarr", *srcs])
    _run_jax_tool("merge_datasets", [tmp_path / "jax.zarr", *srcs])
    got = trb.load_zarr(str(tmp_path / "port.zarr"))
    want = trb.load_zarr(str(tmp_path / "jax.zarr"))   # JAX wrote blosc
    _assert_same_store(got, want)
    assert "car_state" not in got.data
    np.testing.assert_array_equal(got.meta["track_seed"], [11, 12, -1])
    np.testing.assert_array_equal(got.episode_ends, [7, 12, 18])
    from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb

    _assert_same_store(jrb.load_zarr(str(tmp_path / "port.zarr")), want)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run dir: checkpoints at epochs 3 and 5 (of different params),
    hparams.yaml (cosine) and STATS.pkl."""
    root = tmp_path_factory.mktemp("run")
    run = str(root / "run")
    pol = td.DiffusionPolicy(td.PolicyConfig(**CFG), "cpu")
    for epoch, seed in ((3, 1), (5, 2)):
        tck.save_checkpoint(run, pol.init_params(
            torch.Generator().manual_seed(seed)), epoch)
    tck.save_hparams(run, pol.config, tl.TrainConfig(
        lr=4e-4, lr_schedule="cosine", epochs=9, batch_size=8))
    shutil.copy2(REPO / "artifacts" / "r5blend_best" / "STATS.pkl",
                 os.path.join(run, "STATS.pkl"))
    return run


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _jax_snapshot(run, out, dtype=None):
    """The JAX tool, its npz restore given the template that its sidecar
    tool rebuilds from the same npz."""
    from state_policy_diffusionmodel_tpu.train import checkpoints as jck

    rebuild = _jax_tool("make_resume_sidecar").params_from_npz
    load = jck.load_checkpoint

    def with_template(path, like=None):
        return load(path, rebuild(os.path.join(path, "params.npz")))

    with mock.patch.object(jck, "load_checkpoint", with_template):
        _run_jax_tool("snapshot_run", [run, out] + (
            ["--dtype", dtype] if dtype else []))


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_snapshot_run_matches_jax(run_dir, tmp_path, dtype):
    port, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    snapshot_run.main([run_dir, port] + (["--dtype", dtype] if dtype else []))
    _jax_snapshot(run_dir, jax_out, dtype)
    rel = os.path.join("checkpoints", "epoch=5", "params.npz")
    got, want = _npz(os.path.join(port, rel)), _npz(os.path.join(jax_out, rel))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.dtype(dtype or np.float32), k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_out)) == [
        "STATS.pkl", "checkpoints", "hparams.yaml"]
    for side in ("hparams.yaml", "STATS.pkl"):
        assert pathlib.Path(port, side).read_bytes() == \
            pathlib.Path(jax_out, side).read_bytes()
    # a drop-in run dir: the port serves it, at fp32
    pol, params, stats = tck.load_run(port, "cpu")
    assert params["unet"].width == 8 and stats is not None
    assert next(params["unet"].parameters()).dtype == torch.float32


def test_make_resume_sidecar_matches_jax_and_both_resume(run_dir, tmp_path):
    import jax

    from state_policy_diffusionmodel_tpu.train import checkpoints as jck
    from state_policy_diffusionmodel_tpu.train import loop as jl

    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    snapshot_run.main([run_dir, port])
    shutil.copytree(port, jax_dir)
    make_resume_sidecar.main([port])
    _run_jax_tool("make_resume_sidecar", [jax_dir])
    rebuild = _jax_tool("make_resume_sidecar").params_from_npz
    params = rebuild(os.path.join(port, "checkpoints", "epoch=5",
                                  "params.npz"))
    tcfg = jl.TrainConfig(lr=4e-4, lr_schedule="cosine", epochs=9)
    like = jax.device_get(jl.make_optimizer(tcfg).init(params))
    want_state, _ = jck.load_train_state(jax_dir, like)
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(want_state)[0]}
    got = _npz(os.path.join(port, "trainer_state", "opt", "params.npz"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    meta = os.path.join("trainer_state", "meta.yaml")
    assert tck.load_hparams(os.path.join(port, meta)) == \
        jck.load_hparams(os.path.join(jax_dir, meta))
    # refused again without --force; a plateau run needs --lr
    with pytest.raises(SystemExit, match="already exists"):
        make_resume_sidecar.main([port])

    # the JAX package's resume reads the port's sidecar into its optimizer
    opt_state, jmeta = jck.load_train_state(port, like)
    assert jmeta["epoch"] == 5
    assert int(jax.tree.leaves(opt_state)[0]) == 0

    # the port's trainer resumes from it at epoch 6
    from test_torch_parallel import _data_module

    pol = td.DiffusionPolicy(td.PolicyConfig(**CFG), "cpu")
    cfg = tl.TrainConfig(epochs=7, batch_size=8, lr=4e-4,
                         lr_schedule="cosine", early_stop=False)
    dm = _data_module()
    res = tl.Trainer(pol, cfg, port).fit(dm, resume=True)
    with open(os.path.join(port, "metrics.jsonl")) as f:
        events = [e for e in map(json.loads, f) if e["event"] == "resume"]
    assert events and events[0]["epoch"] == 6
    assert os.path.exists(os.path.join(port, "checkpoints", "epoch=6"))
    assert np.isfinite(res["history"]["train_loss"]).all()


def test_make_resume_sidecar_plateau_needs_lr(run_dir, tmp_path):
    run = str(tmp_path / "plateau")
    snapshot_run.main([run_dir, run])
    tck.save_hparams(run, td.PolicyConfig(**CFG), tl.TrainConfig(lr=4e-4))
    with pytest.raises(SystemExit, match="--lr"):
        make_resume_sidecar.main([run])
    make_resume_sidecar.main([run, "--lr", "1e-5"])
    leaves, meta = tck.load_train_state(run)
    assert meta["lr"] == 1e-5 and meta["epoch"] == 5
    assert float(leaves["[1].hyperparams['learning_rate']"]) == \
        np.float32(4e-4)


def test_make_shared_evalset_matches_jax(tmp_path):
    steps = 12
    out = make_shared_evalset.main(["--out", str(tmp_path / "port"),
                                    "--steps", str(steps), "--device", "cpu"])
    _run_jax_tool("make_shared_evalset", ["--out", tmp_path / "jax",
                                          "--steps", steps])
    name = os.path.basename(out)
    assert name == "shared_eval_dataset_6_episodes_3_drivers.zarr"
    got = trb.load_zarr(out)
    want = trb.load_zarr(str(tmp_path / "jax" / name))
    assert sorted(got.data) == sorted(want.data) == [
        "action", "angle", "car_state", "img", "position", "velocity"]
    for k, v in want.data.items():
        assert got.data[k].shape == v.shape and got.data[k].dtype == v.dtype
    np.testing.assert_array_equal(got.episode_ends,
                                  np.arange(1, 7) * steps)
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    for k in ("track_seed", "driver_id"):
        np.testing.assert_array_equal(got.meta[k], want.meta[k])
    np.testing.assert_array_equal(got.meta["track_seed"],
                                  [900, 901, 910, 911, 920, 921])
    np.testing.assert_array_equal(got.meta["driver_id"], [0, 0, 1, 1, 2, 2])
    np.testing.assert_allclose(got.data["position"], want.data["position"],
                               rtol=0, atol=POS_ATOL)
    qa = np.rint(got.data["img"] * 255)
    qb = np.rint(want.data["img"] * 255)
    diff = (qa != qb).reshape(len(qa), -1).sum(-1)
    assert diff.max() <= FRAME_BUDGET, diff
    # the JAX package reads the port's (zlib) store
    from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb

    _assert_same_store(jrb.load_zarr(out), got)


def test_make_shared_evalset_keeps_an_existing_store(tmp_path):
    """An existing store (the committed reference set, where --out is the
    default) is not written over without --force; nothing is collected."""
    store = tmp_path / make_shared_evalset.STORE
    store.mkdir()
    (store / ".zgroup").write_text("{}")
    with pytest.raises(SystemExit, match="--force"):
        make_shared_evalset.main(["--out", str(tmp_path), "--steps", "1",
                                  "--device", "cpu"])
    assert [p.name for p in store.iterdir()] == [".zgroup"]
