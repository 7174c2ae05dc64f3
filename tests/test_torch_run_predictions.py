"""The port's live demo (`cli/run_predictions.py`) against the JAX
package's `cli/run_predictions.py` loop, on CPU.

The JAX loop below is the JAX CLI's `main` with its sampler call replaced
by `_stub`, a function of the frame index alone, and no file written; the
port runs `run_predictions` with the same stub as its `sample_fn`. So both
draw the same predicted trajectories (world points from the same
normalized prediction, the window's translation and the run's stats)
into the frames through their Overlay, and in PID mode the lane follower
drives both. Tolerances are test_torch_env.py's for the env: positions
within POS_ATOL = 1e-3 after 45 steps, frames within FRAME_BUDGET = 30 of
27,648 bytes, actions within 1e-4 (the PID reads the same frames and a
speed that parts by float32 rounding). The tiny run of
test_torch_cli_sample.py (obs 4, step 2: a ring of 8 frames) gives the
stats; `--predict_every 10`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from state_policy_diffusionmodel_tpu import control as JC
from state_policy_diffusionmodel_tpu import envs as JE
from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu.data import normalize as JN
from state_policy_diffusionmodel_tpu.render import Overlay as JOverlay
from state_policy_diffusionmodel_torch.cli import run_predictions as tcli
from state_policy_diffusionmodel_torch.train import load_run

from test_torch_cli_sample import write_episodes, write_run
from test_torch_policy import torch_threads

POS_ATOL = 1e-3
ACT_ATOL = 1e-4
FRAME_BUDGET = 30
TRACK, STEPS, EVERY = 42, 45, 10

_torch_threads = torch_threads(1)


def _stub(step, horizon=7):
    """A normalized (horizon, 5) prediction that depends on the frame
    only: positions spread ahead of the window's first frame, actions in
    [-1, 1]."""
    rng = np.random.default_rng(step)
    pred = rng.uniform(-0.2, 0.2, (horizon, 5)).astype(np.float32)
    pred[:, :2] += np.linspace(0, 0.05, horizon, dtype=np.float32)[:, None]
    return pred


def _frame_bytes(a, b):
    return int((np.asarray(a) != np.asarray(b)).sum())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("runpred")
    write_run(root / "run", write_episodes(root / "ds.zarr"))
    return root


@pytest.fixture(scope="module")
def port_track():
    return tcli.track_bank(TRACK, "cpu")


def _jax_loop(stats, cfg, steps, predict_every, drive="pid"):
    """cli/run_predictions.py's loop of the JAX package, `_stub` in place
    of its sampler."""
    geom = JT.build(JT.make_track(TRACK))
    state, res = jax.jit(JE.reset)(geom)
    ctrl_params = JC.lane_follow_params("middle", 30.0)
    ctrl = JC.lane_follow_init()
    ctrl_jit = jax.jit(JC.lane_follow)
    step_plain = jax.jit(lambda s, a: JE.step(s, geom, a))
    step_overlay = jax.jit(lambda s, a, ov: JE.step(s, geom, a, overlay=ov))
    L = cfg.obs_horizon * cfg.step_size
    hist = {"image": [], "position": [], "velocity": [], "action": []}
    frames, positions, actions, overlay_pts = [], [], [], []
    policy_action = None
    for step in range(steps):
        speed = jnp.linalg.norm(res.info.car_velocity)
        action, ctrl = ctrl_jit(ctrl_params, ctrl, res.augmented, speed)
        hist["image"].append(np.asarray(res.obs, np.float32) / 255.0)
        hist["position"].append(np.asarray(res.info.car_position))
        hist["velocity"].append(np.asarray(res.info.car_velocity))
        hist["action"].append(np.asarray(action))
        for k in hist:
            hist[k] = hist[k][-L:]
        overlay = None
        every = cfg.step_size if drive == "policy" else predict_every
        if len(hist["position"]) >= L and step % every == 0:
            sub = {k: np.stack(v[::cfg.step_size])[None]
                   for k, v in hist.items()}
            _, trans = JN.normalize_position(sub["position"][0],
                                             stats["position"])
            pred = _stub(step)
            world = JN.unnormalize_position(pred[:, :2], trans,
                                            stats["position"])
            if drive != "policy" or step % predict_every == 0:
                overlay_pts.append(world.astype(np.float32))
                overlay_pts = overlay_pts[-8:]
            if drive == "policy":
                acts = JN.unnormalize_data(pred[:, 2:5], stats["action"])
                policy_action = jnp.asarray(
                    np.asarray(acts)[cfg.inpaint_horizon])
        if overlay_pts:
            pts = np.zeros((8, cfg.horizon, 2), np.float32)
            valid = np.zeros(8, bool)
            for i, w in enumerate(overlay_pts):
                pts[i], valid[i] = w, True
            overlay = JOverlay(jnp.asarray(pts), jnp.asarray(valid))
        if drive == "policy" and policy_action is not None:
            action = policy_action
            hist["action"][-1] = np.asarray(action)
        if overlay is None:
            state, res = step_plain(state, action)
        else:
            state, res = step_overlay(state, action, overlay)
        frames.append(np.asarray(res.augmented))
        positions.append(np.asarray(res.info.car_position))
        actions.append(np.asarray(action))
        if bool(res.done):
            break
    return np.stack(frames), np.stack(positions), np.stack(actions)


def test_pid_demo_follows_jax(tiny, port_track):
    policy, params, stats = load_run(str(tiny / "run"), "cpu")
    out = tcli.run_predictions(policy, params, stats, port_track,
                               steps=STEPS, predict_every=EVERY,
                               sample_fn=lambda batch, step: _stub(step))
    frames, positions, actions = _jax_loop(stats, policy.config, STEPS,
                                           EVERY)
    assert out["frames"].shape == frames.shape == (STEPS, 96, 96, 3)
    # the ring of 8 frames is full at frame 7: predictions at 10, 20, ...
    assert [s for s, _ in out["predictions"]] == [10, 20, 30, 40]
    assert out["denoises"] == 4
    np.testing.assert_allclose(out["positions"], positions, rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(out["actions"], actions, rtol=0,
                               atol=ACT_ATOL)
    worst = max(_frame_bytes(a, b) for a, b in zip(out["frames"], frames))
    assert worst <= FRAME_BUDGET
    # the overlay is drawn from the first prediction on: the last state
    # rendered without it loses the red polylines
    from state_policy_diffusionmodel_torch.render import raster

    with_ov = raster.render(out["state"].car, port_track,
                            overlay=out["overlay"])[0]
    without = raster.render(out["state"].car, port_track)[0]
    red = torch.tensor(raster.PALETTE_U8[raster.L_POINTS])
    drawn = (with_ov[0] == red).all(-1) & ~(without[0] == red).all(-1)
    assert int(drawn.sum()) > 0


def test_policy_demo_records_the_executed_action(tiny, port_track):
    policy, params, stats = load_run(str(tiny / "run"), "cpu")
    steps = 20
    out = tcli.run_predictions(policy, params, stats, port_track,
                               steps=steps, predict_every=EVERY,
                               drive="policy",
                               sample_fn=lambda batch, step: _stub(step))
    frames, positions, actions = _jax_loop(stats, policy.config, steps,
                                           EVERY, drive="policy")
    # a denoise every step_size frames once the ring is full (8, 10, ..)
    assert out["denoises"] == len(range(8, steps, 2))
    # the action row inpaint_horizon of the newest prediction, held
    from state_policy_diffusionmodel_torch.data import normalize as TN

    for k in range(8, steps):
        row = TN.unnormalize_data(_stub(k - k % 2)[:, 2:5],
                                  stats["action"])[1]
        np.testing.assert_allclose(out["actions"][k], row, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(out["actions"], actions, rtol=0,
                               atol=ACT_ATOL)
    np.testing.assert_allclose(out["positions"], positions, rtol=0,
                               atol=POS_ATOL)
    # the policy's own sampler drives too
    out = tcli.run_predictions(policy, params, stats, port_track, steps=14,
                               predict_every=EVERY, drive="policy",
                               num_inference_steps=3)
    assert out["denoises"] == 3 and np.isfinite(out["actions"]).all()


def test_main_writes_the_video(tiny, tmp_path):
    pytest.importorskip("PIL")
    out = tcli.main(["--run_dir", str(tiny / "run"), "--ema", "--steps", "12",
                     "--predict_every", "4", "--num_inference_steps", "2",
                     "--out", str(tmp_path / "demo.mp4"), "--device", "cpu"])
    # an .mp4 through ffmpeg, else a .gif
    assert out["path"].endswith((".mp4", ".gif"))
    assert os.path.getsize(out["path"]) > 0 and len(out["frames"]) == 12
    assert len(out["predictions"]) == 1          # frame 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--run_dir", str(tiny / "run")])
