"""Parity of the PyTorch port's eval suite, rollouts and sample figures with
the JAX package, on CPU, and the port's evaluate entry point.

Both packages evaluate one width-8 UNet_Film (shared weights, no vision
encoder, obs 4 / pred 6 / inpaint 1 / step 2, DDIM-5 leading over 1000
noise steps) on one dataset: two 60-step lane-follower episodes on track
42, collected by the port with car_state vectors. The samplers get the
same x_T: the port's EvalContext through its `init_noise_fn`, the JAX one
through its jitted sampler replaced by one that passes `init_noise`, both
fed from one numpy stream in call order.

Tolerances:
- normalized predictions agree within CHAIN_ATOL = 2e-3
  (tests/test_torch_policy.py: two float32 U-Nets differ by ~4e-6 in eps
  and a DDIM chain amplifies that); a metric in world units is held to
  CHAIN_ATOL times the position range (max - min of the stats), which
  unnormalizes a normalized difference d to at most d * (max - min);
- env replays (positions) within POS_ATOL = 1e-3, as tests/test_torch_env.py
  holds the env, plus the chain tolerance of the actions they execute;
- interpolate_actions and hold_actions equal; the O(1) warm start against
  the replay warm start within 5e-3, as tests/test_eval.py holds JAX.
"""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu import envs as JE
from state_policy_diffusionmodel_tpu import eval as JEV
from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu import train as jtrain
from state_policy_diffusionmodel_tpu.data import dataset as jds
from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_tpu.utils import plotting as jplot
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch import eval as TEV
from state_policy_diffusionmodel_torch import train as ttrain
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.cli import evaluate as tcli
from state_policy_diffusionmodel_torch.data import collect as tcollect
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.data import replay_buffer as trb
from state_policy_diffusionmodel_torch.envs import car_racing as tenv
from state_policy_diffusionmodel_torch.params_from_jax import params_from_jax
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.utils import plotting as tplot

from test_torch_policy import CHAIN_ATOL, torch_threads

POS_ATOL = 1e-3
WARM_ATOL = 5e-3
CFG = dict(noise_steps=1000, obs_horizon=4, pred_horizon=6,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="none",
           step_size=2, model_width=8)
EVAL = dict(sampler="ddim", num_inference_steps=5, ddim_spacing="leading")
TRACK = 42
WINDOW = 45            # in the second episode


one_torch_thread = torch_threads(1)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def test_interpolate_and_hold_actions_match_jax():
    rng = np.random.default_rng(0)
    sparse = rng.normal(size=(3, 7, 3)).astype(np.float32)
    for step in (1, 2, 5):
        want = jax.vmap(lambda a: JEV.interpolate_actions(a, step))(
            jnp.asarray(sparse))
        got = TEV.interpolate_actions(torch.from_numpy(sparse), step)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(
            _np(TEV.interpolate_actions(torch.from_numpy(sparse[0]), step)),
            np.asarray(want[0]))
        want = jax.vmap(lambda a: JEV.hold_actions(a, step))(
            jnp.asarray(sparse))
        got = TEV.hold_actions(torch.from_numpy(sparse), step)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def tracks():
    """Track 42 as the port's one-track bank and as JAX's geometry."""
    bank = TT.stack([TT.build(TT.make_track(TRACK), bake=False,
                              device="cpu")])
    geom = JT.TrackGeometry(*(jnp.asarray(x.numpy()[0]) for x in bank))
    return bank, geom


def test_replay_and_replay_batch_match_jax(tracks):
    """12 frames of 3 random action sequences (the length and count the
    precision eval replays, so JAX compiles these programs once)."""
    bank, geom = tracks
    rng = np.random.default_rng(1)
    acts = np.stack([rng.uniform(-0.4, 0.4, (3, 12)),
                     rng.uniform(0.5, 1.0, (3, 12)),
                     np.zeros((3, 12))], -1).astype(np.float32)
    js0, _ = JE.reset(geom, render=False)
    ts0, _ = tenv.reset(bank, torch.zeros(1, dtype=torch.int32),
                        render=False)
    _, jpos, (jvel, jrew) = JEV.replay(geom, js0, jnp.asarray(acts[0]), 12)
    ts, tpos, (tvel, trew) = TEV.replay(bank, ts0,
                                        torch.from_numpy(acts[:1]), 12)
    np.testing.assert_allclose(_np(tpos[0]), np.asarray(jpos), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(_np(tvel[0]), np.asarray(jvel), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(_np(trew[0]), np.asarray(jrew), rtol=0,
                               atol=1e-4)
    assert float(np.abs(np.asarray(jpos[-1] - jpos[0])).sum()) > 0.05
    _, jtraj, _ = JEV.replay_batch(geom, js0, jnp.asarray(acts), 12)
    _, ttraj, _ = TEV.replay_batch(bank, ts0, torch.from_numpy(acts), 12)
    assert tuple(ttraj.shape) == (3, 12, 2)
    np.testing.assert_allclose(_np(ttraj), np.asarray(jtraj), rtol=0,
                               atol=POS_ATOL)
    # the batch's first sequence is the single replay
    np.testing.assert_array_equal(_np(ttraj[0]), _np(tpos[0]))


# ---------------------------------------------------------------------------
# the eval suite
# ---------------------------------------------------------------------------

class NoiseStream:
    """x_T draws in call order: (n, horizon, 5) uniform, as the policy's
    uniform init draws them."""

    def __init__(self, seed=123, horizon=7):
        self.rng = np.random.default_rng(seed)
        self.horizon = horizon

    def __call__(self, n, seed=None):
        return self.rng.uniform(size=(n, self.horizon, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def episodes():
    bank = TT.stack([TT.build(TT.make_track(TRACK), device="cpu")] * 2)
    eps = tcollect.collect_episodes([TRACK, TRACK], n_steps=60, chunk=60,
                                    geoms=bank, return_states=True,
                                    device="cpu")
    buf = trb.ReplayBuffer()
    for ep in eps:
        buf.add_episode(ep)
    buf.meta["track_seed"] = np.array([TRACK, TRACK], np.int64)
    return buf


@pytest.fixture(scope="module")
def policies():
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**CFG))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + (rng.normal(size=p.shape) * 0.02).astype(np.float32),
        jpol.init_params(jax.random.key(0)))
    tpol = td.DiffusionPolicy(td.PolicyConfig(**CFG), device="cpu")
    return jpol, params, tpol, params_from_jax(params, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_sampler(jpol):
    """The JAX sampler with x_T passed in, jitted once for every test (so
    each batch shape compiles once)."""
    return jax.jit(lambda p, b, r, x: jpol.sample(p, b, r, init_noise=x,
                                                  **EVAL))


def _contexts(policies, buf, car_states=True):
    jpol, jparams, tpol, tparams = policies
    data = buf if car_states else trb.ReplayBuffer(
        {k: v for k, v in buf.data.items() if k != "car_state"},
        buf.episode_ends, buf.meta)
    stats = tds.WindowDataset(data, 4, 6, 2).stats
    jdata = jrb.ReplayBuffer(dict(data.data), data.episode_ends,
                             dict(data.meta))
    jctx = JEV.EvalContext(policy=jpol, params=jparams,
                           dataset=jds.WindowDataset(jdata, 4, 6, 2, stats),
                           **EVAL)
    jstream = NoiseStream()
    jsample = _jax_sampler(jpol)
    object.__setattr__(jctx, "_sample_jit", lambda p, b, r: jsample(
        p, b, r, jnp.asarray(jstream(b["position"].shape[0]))))
    tctx = TEV.EvalContext(policy=tpol, params=tparams,
                           dataset=tds.WindowDataset(data, 4, 6, 2, stats),
                           init_noise_fn=NoiseStream(), **EVAL)
    scale = float(stats["position"]["max"] - stats["position"]["min"])
    return jctx, tctx, CHAIN_ATOL * scale


def _same(got, want, atol, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, atol, f"{path}[{i}]")
    else:
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)


REPLAYS = {"rollout_positions", "trajectories", "pred_replay_trajectory",
           "gt_replay_trajectory", "executed"}


@pytest.mark.parametrize("name,call", [
    ("position_consistency", lambda E, c: E.position_consistency(
        c, WINDOW, n_runs=3)),
    ("position_accuracy", lambda E, c: E.position_accuracy(
        c, max_windows=7, chunk=4)),
    ("precision", lambda E, c: E.precision(c, WINDOW, n_runs=3)),
    ("action_consistency", lambda E, c: E.action_consistency(
        c, WINDOW, n_runs=3)),
    ("robustness", lambda E, c: E.robustness(c, WINDOW, n_levels=3)),
    ("compare_position_actions", lambda E, c: E.compare_position_actions(
        c, WINDOW)),
    ("smoke", lambda E, c: E.smoke(c, 3))])
def test_eval_matches_jax(policies, episodes, name, call):
    """Each eval in both packages on the same data and x_T (the O(1) warm
    start from car_state)."""
    jctx, tctx, atol = _contexts(policies, episodes)
    want = call(JEV, jctx)
    got = call(TEV, tctx)
    for k in want:
        tol = atol + POS_ATOL if k in REPLAYS else atol
        _same(got[k], want[k], tol, f"{name}.{k}")
    if name == "robustness":
        assert [r["alpha"] for r in got["levels"]] == [0.0, 0.01, 0.02]


def test_evals_on_the_replay_warm_start_match_jax(policies, episodes):
    """Without car_state both packages warm-start by replaying the
    episode's actions; precision agrees."""
    jctx, tctx, atol = _contexts(policies, episodes, car_states=False)
    assert getattr(tctx.dataset, "car_state") is None
    want = JEV.precision(jctx, WINDOW, n_runs=3)
    got = TEV.precision(tctx, WINDOW, n_runs=3)
    for k in want:
        tol = atol + POS_ATOL if k in REPLAYS else atol
        _same(got[k], want[k], tol, k)


def test_warmed_state_o1_restore_matches_replay(policies, episodes):
    """The O(1) car_state restore against the replay of the episode's own
    actions (within 5e-3, as JAX's own test), and each path against
    JAX's."""
    jctx, tctx, _ = _contexts(policies, episodes)
    jplain, tplain, _ = _contexts(policies, episodes, car_states=False)
    for window in (0, 20, WINDOW, 70):
        start = tctx.window(window)[2]
        _, s_o1, acts, n_warm = tctx.warmed_state(start)
        _, s_rep, acts2, n_warm2 = tplain.warmed_state(start)
        assert n_warm == n_warm2
        np.testing.assert_array_equal(acts, acts2)
        np.testing.assert_allclose(_np(s_o1.car.pos[0]),
                                   _np(s_rep.car.pos[0]), rtol=0,
                                   atol=WARM_ATOL)
        np.testing.assert_allclose(_np(s_o1.car.vel[0]),
                                   _np(s_rep.car.vel[0]), rtol=0,
                                   atol=WARM_ATOL)
        # the recorded pose at the end of the observation span
        ep, ep_start, _ = tctx.episode_of(start)
        np.testing.assert_allclose(
            _np(s_o1.car.pos[0]),
            episodes.data["car_state"][ep_start + n_warm - 1, :2], atol=0)
        for t_ctx, j_ctx in ((tctx, jctx), (tplain, jplain)):
            _, ts, _, _ = t_ctx.warmed_state(start)
            _, js, _, _ = j_ctx.warmed_state(start)
            for g, w in zip(ts.car, js.car):
                np.testing.assert_allclose(_np(g[0]), np.asarray(w),
                                           rtol=0, atol=POS_ATOL)


# ---------------------------------------------------------------------------
# sample figures and the entry point
# ---------------------------------------------------------------------------

def _store(buf, path):
    buf.save_to_path(path)
    return path


def test_sample_hook_matches_jax(policies, episodes, tmp_path):
    """The hook's plotted arrays equal JAX's (predictions within the chain
    tolerance) for the same x_T, and it writes both PNGs."""
    jpol, jparams, tpol, tparams = policies
    _store(episodes, str(tmp_path / "s.zarr"))
    kw = dict(batch_size=4, data_dir=str(tmp_path), T_obs=4, T_pred=6,
              seed=0, step_size=2)
    jdm, tdm = jds.DataModule(**kw), tds.DataModule(**kw)
    jdm.setup("s.zarr")
    tdm.setup("s.zarr")
    x_T = NoiseStream(seed=5)(1)

    def spy(store, fn):
        def wrapped(*a, **k):
            store.append(k)
            return fn(*a, **k)
        return wrapped

    jsample = jpol.sample
    seen = {pkg: {"pos": [], "act": []} for pkg in ("jax", "port")}
    with mock.patch.object(jplot, "plot_prediction_overlay",
                           spy(seen["jax"]["pos"],
                               jplot.plot_prediction_overlay)), \
            mock.patch.object(jplot, "plot_action_comparison",
                              spy(seen["jax"]["act"],
                                  jplot.plot_action_comparison)), \
            mock.patch.object(jpol, "sample", lambda *a, **k: jsample(
                *a, init_noise=jnp.asarray(x_T), **k)):
        hook = jtrain.make_sample_hook(jpol, jdm, str(tmp_path / "j"),
                                       num_inference_steps=5)
        hook(jparams, 7)
    with mock.patch.object(tplot, "plot_prediction_overlay",
                           spy(seen["port"]["pos"],
                               tplot.plot_prediction_overlay)), \
            mock.patch.object(tplot, "plot_action_comparison",
                              spy(seen["port"]["act"],
                                  tplot.plot_action_comparison)), \
            mock.patch.object(tpol, "init_noise",
                              lambda n, g=None: torch.from_numpy(x_T)):
        hook = ttrain.make_sample_hook(tpol, tdm, str(tmp_path / "t"),
                                       num_inference_steps=5)
        hook(tparams, 7)
    # a normalized difference d unnormalizes to at most d * (max - min)
    span = {k: float(np.max(tdm.stats[key]["max"] - tdm.stats[key]["min"]))
            for k, key in (("pos", "position"), ("act", "action"))}
    for kind in ("pos", "act"):
        (want,), (got,) = seen["jax"][kind], seen["port"][kind]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if isinstance(w, str) or np.isscalar(w):
                assert got[k] == w, k
            else:
                _same(got[k], w, CHAIN_ATOL * span[kind], k)
    for tag in ("positions", "actions"):
        png = tmp_path / "t" / "samples" / f"step_0000007_{tag}.png"
        assert png.stat().st_size > 1000


def test_evaluate_cli_on_cpu_and_without_a_card(policies, episodes,
                                                tmp_path):
    """`evaluate all` end to end on a tiny store and a width-8 run dir;
    without --device cpu it raises when there is no card."""
    _, _, tpol, tparams = policies
    data = _store(episodes, str(tmp_path / "s.zarr"))
    run = str(tmp_path / "run")
    tck.save_checkpoint(run, tparams, 0)
    tck.save_hparams(run, tpol.config)
    tds.save_stats(tds.WindowDataset(data, 4, 6, 2).stats,
                   os.path.join(run, "STATS.pkl"))
    args = ["all", "--run_dir", run, "--dataset_dir", str(tmp_path),
            "--dataset_name", "s.zarr", "--window", "30", "--n_runs", "2",
            "--num_inference_steps", "3", "--max_windows", "5",
            "--out", str(tmp_path / "ev.json")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(args)
    out = tcli.main(args + ["--device", "cpu"])
    assert list(out) == tcli.EVALS
    for name, res in out.items():
        assert res["seconds"] > 0
        for k, v in res.items():
            if isinstance(v, np.ndarray):
                assert np.isfinite(v).all(), (name, k)
    assert out["accuracy"]["per_window_error"].shape == (5,)
    assert (tmp_path / "ev.json").exists()
    assert (tmp_path / "ev_smoke_overlay.png").exists()
