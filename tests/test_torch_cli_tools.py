"""The port's dataset figures (`cli/visualize_dataset.py`), keyboard demo
(`cli/play.py`, headless) and sweeps (`sweeps.py`), on CPU.

- visualize_dataset: for each of positions, actions, images and
  normalized, the port's PNG equals the JAX CLI's pixel for pixel on the
  same store (the port reads it with its own zarr reader, the JAX CLI with
  tensorstore; both draw with matplotlib at 100 dpi).
- play: the key map (press and release of each key, reset, quit) and the
  step loop: reward summed, the episode restarted on reset, a log line
  every 200 steps.
- sweeps: `drive` and `eval` over two rows of a tiny run (width 8) write
  the JAX tools' JSON layout, skip rows already written, and take rows
  from the command line or a JSON file; the default rows are the
  exported runs in artifacts/.
"""

import ast
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_torch import sweeps
from state_policy_diffusionmodel_torch.cli import play
from state_policy_diffusionmodel_torch.cli import visualize_dataset as tvis

from test_torch_cli_sample import write_episodes, write_run
from test_torch_policy import torch_threads

_torch_threads = torch_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    write_run(root / "run", write_episodes(root / "ds.zarr",
                                           lengths=(140, 120)))
    return root


@pytest.mark.parametrize("what", tvis.WHATS)
def test_visualize_dataset_png_equals_jax(tiny, tmp_path, monkeypatch, what):
    pytest.importorskip("matplotlib")
    from PIL import Image

    import cli.visualize_dataset as jvis

    extra = ["--window_len", "50", "--n_windows", "3"]
    got = tvis.main([str(tiny / "ds.zarr"), "--what", what, "--episode", "1",
                     "--out", str(tmp_path / "port.png"), *extra])
    monkeypatch.setattr(sys, "argv", [
        "visualize_dataset", str(tiny / "ds.zarr"), "--what", what,
        "--episode", "1", "--out", str(tmp_path / "jax.png"), *extra])
    jvis.main()
    a = np.asarray(Image.open(got))
    b = np.asarray(Image.open(tmp_path / "jax.png"))
    assert a.shape == b.shape and np.array_equal(a, b)


def test_normalized_windows_stats(tiny):
    from state_policy_diffusionmodel_torch.data import load_zarr

    buf = load_zarr(str(tiny / "ds.zarr"))
    res = tvis.normalized_windows(buf, n_windows=5, window_len=50, seed=2)
    assert len(res["windows"]) == 5
    for w, raw, normed, centered in res["windows"]:
        assert raw.shape == (50, 2)
        assert np.allclose(normed.min(0), -1) and np.allclose(normed.max(0), 1)
        assert np.array_equal(centered[0], np.zeros(2, np.float32))
    assert res["mean_min"] < res["mean_max"]


def test_play_key_map_and_step_loop():
    action = np.zeros(3, np.float32)
    flags = {"quit": False, "reset": False}
    for key, want in (("left", [-1, 0, 0]), ("up", [-1, 1, 0]),
                      ("down", [-1, 1, 0.8]), ("right", [1, 1, 0.8])):
        play.on_key(action, flags, key, True)
        np.testing.assert_allclose(action, want, rtol=0, atol=1e-7)
    for key in ("right", "up", "down"):
        play.on_key(action, flags, key, False)
    np.testing.assert_array_equal(action, np.zeros(3, np.float32))
    play.on_key(action, flags, "r", False)
    assert flags == {"quit": False, "reset": False}
    play.on_key(action, flags, "r", True)
    play.on_key(action, flags, "q", True)
    assert flags == {"quit": True, "reset": True}

    lines = []
    game = play.Game(seed=3, device="cpu", log=lines.append)
    assert game.frame().shape == (96, 96, 3)
    play.on_key(game.action, game.flags, "up", True)
    total = 0.0
    for _ in range(25):
        frame = game.tick()
        total += float(game.res.reward[0])
    assert frame.dtype == np.uint8 and game.steps == 25
    assert game.total == pytest.approx(total)
    assert float(game.state.car.vel.norm()) > 1.0       # the gas was held
    game.flags["reset"] = True
    game.tick()
    assert game.steps == 1 and not game.flags["reset"]
    game.steps = 199
    game.tick()
    assert lines == [f"action [0.0, 1.0, 0.0] step 200 total_reward "
                     f"{game.total:+0.2f}"]
    game_augm = play.Game(seed=3, augmented=True, device="cpu")
    assert not np.array_equal(game_augm.frame(), play.Game(
        seed=3, device="cpu").frame())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            play.Game(seed=3)


def test_sweeps_drive_and_eval_two_rows(tiny, tmp_path, capsys):
    run = str(tiny / "run")
    rows = ["--row", f"a={run}", "--row",
            f"b={run}:ema=true,ddim_spacing=trailing,num_inference_steps=2"]
    drive = ["drive", "--out", str(tmp_path), "--envs", "2",
             "--metrics_frames", "12", "--metrics_repeats", "2",
             "--unique_tracks", "1", "--device", "cpu"]
    done = sweeps.main(drive + rows)
    assert set(done) == {"a", "b"}
    for name in ("a", "b"):
        with open(tmp_path / f"drive_{name}.json") as f:
            payload = json.load(f)
        assert payload["metric"] == "closed_loop_driving"
        assert payload["row"] == name
        d = payload["driving"]
        assert {"tiles_per_sim_minute", "reward_per_sim_minute",
                "done_fraction", "metrics_repeats",
                "tiles_per_sim_minute_runs"} <= set(d)
        assert len(d["tiles_per_sim_minute_runs"]) == 2
    # written rows are skipped
    assert sweeps.main(drive + rows) == {}
    assert "a: exists, skip" in capsys.readouterr().out

    rows_file = tmp_path / "rows.json"
    rows_file.write_text(json.dumps([
        ["lead", run, {"num_inference_steps": 2}],
        ["trail", run, {"ema": True, "ddim_spacing": "trailing",
                        "num_inference_steps": 2}]]))
    done = sweeps.main(["eval", "--out", str(tmp_path), "--rows_file",
                        str(rows_file), "--max_windows", "4",
                        "--dataset_dir", str(tiny), "--dataset_name",
                        "ds.zarr", "--device", "cpu"])
    assert set(done) == {"lead", "trail"}
    for name in ("lead", "trail"):
        with open(tmp_path / f"acc_{name}.json") as f:
            acc = json.load(f)["accuracy"]
        assert {"overall", "action_overall", "action_mae_gas",
                "action_bias_gas", "action_bias_steer",
                "per_window_error"} <= set(acc)
        assert len(acc["per_window_error"]) == 4
        assert np.isfinite(acc["overall"])
    # --rows keeps the named ones
    assert set(sweeps.main(["eval", "--out", str(tmp_path / "x"),
                            "--rows_file", str(rows_file), "--rows", "trail",
                            "--max_windows", "2", "--dataset_dir", str(tiny),
                            "--dataset_name", "ds.zarr",
                            "--device", "cpu"])) == {"trail"}


def test_sweep_rows_parse_and_default():
    assert sweeps.parse_row("x=runs/a:ema=true,epoch=4,ddim_spacing=trailing") \
        == ("x", "runs/a", {"ema": True, "epoch": 4,
                            "ddim_spacing": "trailing"})
    assert sweeps.parse_row("y=runs/b") == ("y", "runs/b", {})
    with pytest.raises(ValueError, match="NAME=RUN_DIR"):
        sweeps.parse_row("nothing")
    rows = sweeps.default_rows("drive")
    names = [r[0] for r in rows]
    assert "r5blend_ema_ddim10" in names and "r5blend_ema_trailing" in names
    assert all(kw["ema"] for _, _, kw in rows)
    assert [r[0] for r in sweeps.default_rows("eval")][:2] == [
        names[0].replace("_ddim10", ""), names[1]]


# imported only inside the functions that need them: the card's machine
# has none of these
_LAZY = {"PIL", "matplotlib", "tensorstore", "zarr", "numcodecs",
         "zstandard", "tensorboard", "triton"}


def test_optional_packages_are_not_imported_at_module_level():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "state_policy_diffusionmodel_torch").rglob(
        "*.py")) + [root / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.parse(f.read_text()).body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in _LAZY
                    or n.startswith("torch.utils.tensorboard")]
    assert not bad
