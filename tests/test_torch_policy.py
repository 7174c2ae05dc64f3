"""Parity of the PyTorch port's diffusion math, sampler and ring policy with
the JAX package, on CPU; and the port's isolation from JAX.

x_T cannot come from the same random bits in both frameworks, so every
sampler comparison injects it: `init_noise` for `DiffusionPolicy.sample`,
`init_noise_fn` for the ring policy, fed the draws the JAX ring makes.
Policies run at model_width=8 with the r5blend horizons and feature sizes;
flax params go to the port through the weight bridge.
"""

import ast
import collections
import dataclasses
import os
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import state_policy_diffusionmodel_torch as port
from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu.diffusion import schedules as js
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.diffusion import schedules as ts
from state_policy_diffusionmodel_torch.params_from_jax import (
    load_npz, params_from_jax,
)
from state_policy_diffusionmodel_torch.train import load_run, load_stats

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "artifacts" / "r5blend_best"

Res = collections.namedtuple("Res", "obs info")
Info = collections.namedtuple("Info", "car_position car_velocity")


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def torch_threads(n):
    """An autouse module fixture that runs the module's torch work on at
    most `n` intra-op threads: pytest-xdist runs several test processes on
    the host's cores, and oversubscribed OpenMP pools spin (a fit measured
    >10x slower with the default count than alone), while small eager ops
    are as fast on one thread. No check depends on the count."""

    @pytest.fixture(scope="module", autouse=True)
    def fixture():
        before = torch.get_num_threads()
        torch.set_num_threads(min(n, before))
        yield
        torch.set_num_threads(before)

    return fixture


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "linear_v2", "cosine"])
def test_betas_and_schedule_match(kind):
    np.testing.assert_array_equal(ts.SCHEDULES[kind](1000),
                                  js.SCHEDULES[kind](1000))
    want = js.make_schedule(1000, kind)
    got = ts.make_schedule(1000, kind, device="cpu")
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("n", [1, 5, 10, 50, 100, 1000])
def test_ddim_timesteps_match(spacing, n):
    np.testing.assert_array_equal(ts.ddim_timesteps(1000, n, spacing),
                                  js.ddim_timesteps(1000, n, spacing))


def _step_inputs(seed, shape=(4, 31, 5)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,prev_t", [(999, 899), (900, 800), (99, -1),
                                      (0, -1), (450, 350)])
def test_ddim_and_dpmpp_steps_match(t, prev_t):
    eps, x, m_prev = _step_inputs(t)
    js_s, ts_s = js.make_schedule(1000), ts.make_schedule(1000, device="cpu")
    want = js.ddim_step(js_s, jnp.asarray(eps), t, prev_t, jnp.asarray(x))
    got = ts.ddim_step(ts_s, torch.from_numpy(eps), t, prev_t,
                       torch.from_numpy(x))
    _close(got, want, 1e-6)
    lam_prev = np.float32(-1.5)
    # the sampler's last step (prev_t = -1) is always first order
    for second in (False,) if prev_t < 0 else (False, True):
        want = js.dpmpp_2m_step(js_s, jnp.asarray(eps), t, prev_t,
                                jnp.asarray(x), jnp.asarray(m_prev),
                                jnp.asarray(lam_prev), jnp.asarray(second))
        got = ts.dpmpp_2m_step(ts_s, torch.from_numpy(eps), t, prev_t,
                               torch.from_numpy(x), torch.from_numpy(m_prev),
                               torch.tensor(lam_prev), second)
        for a, b in zip(got, want):
            _close(a, b, 1e-6)


@pytest.mark.parametrize("t,prev_t", [(900, 800), (99, -1), (450, 350)])
def test_dpmpp_x0_fix_matches(t, prev_t):
    """The x0-space hook: a fix that pins the first two frames of the x0
    prediction and halves the rest, applied after the clip as in JAX."""
    eps, x, m_prev = _step_inputs(t)
    js_s, ts_s = js.make_schedule(1000), ts.make_schedule(1000, device="cpu")
    pin = np.random.default_rng(t).uniform(-1, 1, x[:, :2].shape).astype(
        np.float32)

    def jfix(m):
        return (m * 0.5).at[:, :2].set(jnp.asarray(pin))

    def tfix(m):
        m = m * 0.5
        m[:, :2] = torch.from_numpy(pin)
        return m

    for second in (False,) if prev_t < 0 else (False, True):
        want = js.dpmpp_2m_step(js_s, jnp.asarray(eps), t, prev_t,
                                jnp.asarray(x), jnp.asarray(m_prev),
                                jnp.asarray(np.float32(-1.5)),
                                jnp.asarray(second), x0_fix=jfix)
        got = ts.dpmpp_2m_step(ts_s, torch.from_numpy(eps), t, prev_t,
                               torch.from_numpy(x), torch.from_numpy(m_prev),
                               torch.tensor(np.float32(-1.5)), second,
                               x0_fix=tfix)
        np.testing.assert_array_equal(got[1][:, :2].numpy(), pin)
        for a, b in zip(got, want):
            _close(a, b, 1e-6)


@pytest.mark.parametrize("t", [999, 500, 1, 0])
def test_ddpm_step_and_add_noise_match(t):
    eps, x, z = _step_inputs(t + 1)
    js_s, ts_s = js.make_schedule(1000), ts.make_schedule(1000, device="cpu")
    for clip in (False, True):
        want = js.ddpm_step(js_s, jnp.asarray(eps), t, jnp.asarray(x),
                            jnp.asarray(z), clip_sample=clip)
        got = ts.ddpm_step(ts_s, torch.from_numpy(eps), t,
                           torch.from_numpy(x), torch.from_numpy(z),
                           clip_sample=clip)
        _close(got, want, 1e-6)
    tb = np.array([t, 3, 999, 0], np.int64)
    want = js.add_noise(js_s, jnp.asarray(x), jnp.asarray(z), jnp.asarray(tb))
    got = ts.add_noise(ts_s, torch.from_numpy(x), torch.from_numpy(z),
                       torch.from_numpy(tb))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# policy at width 8
# ---------------------------------------------------------------------------

CFG = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="autoencoder",
           step_size=5, model_width=8)


@pytest.fixture(scope="module")
def width8():
    """(jax policy, jax params, torch policy, torch params) sharing weights."""
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**CFG))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + (rng.normal(size=p.shape) * 0.02).astype(np.float32),
        jpol.init_params(jax.random.key(0)))
    tpol = td.DiffusionPolicy(td.PolicyConfig(**CFG), device="cpu")
    return jpol, params, tpol, params_from_jax(params, device="cpu")


def _window(rng, B, T, latent=128):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"position": f(B, T, 2), "velocity": f(B, T, 2),
            "action": f(B, T, 3), "image_features": f(B, T, latent)}


# Two float32 implementations of the U-Net differ by ~4e-6 in eps (each is
# ~3e-6 from a float64 run), and the sampler chain amplifies that: DDIM's
# x0 = (x - sqrt(1 - a) eps) / sqrt(a) multiplies eps by 1/sqrt(a), ~60 at
# the first leading step (t=900) and ~157 at the first trailing one
# (t=999). So one step given the same x_t agrees to 2e-5, and a 10-step
# chain to 2e-3 (the JAX package's own leading chain lies 3.9e-4 from a
# float64 run of the same chain).
STEP_ATOL, CHAIN_ATOL = 2e-5, 2e-3


@pytest.mark.parametrize("sampler,spacing", [
    ("ddim", "leading"), ("ddim", "trailing"), ("dpmpp", "trailing")])
def test_sample_10_steps_matches(width8, sampler, spacing):
    jpol, jparams, tpol, tparams = width8
    rng = np.random.default_rng(1)
    batch = _window(rng, 4, 10)
    x_T = rng.uniform(size=(4, 31, 5)).astype(np.float32)
    want = np.asarray(jax.jit(partial(
        jpol.sample, sampler=sampler, num_inference_steps=10,
        ddim_spacing=spacing, history=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), init_noise=jnp.asarray(x_T)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tpol.sample(tparams, tbatch, sampler=sampler,
                      num_inference_steps=10, ddim_spacing=spacing,
                      history=True, init_noise=torch.from_numpy(x_T))
    assert tuple(got.shape) == (11, 4, 31, 5)
    _close(got, want, CHAIN_ATOL)
    if sampler != "ddim":
        return
    # each DDIM step from the JAX chain's own x_t
    cond = tpol.obs_cond(tparams, tbatch)
    inpaint = tpol.inpaint_vector(tbatch)
    ts_ = ts.ddim_timesteps(1000, 10, spacing)
    prev = list(ts_[1:]) + [-1]
    with torch.no_grad():
        for i, (t, p) in enumerate(zip(ts_, prev)):
            x = torch.tensor(want[i])
            eps = tparams["unet"](x[..., None], torch.full((4,), int(t)),
                                  cond)[..., 0]
            x = ts.ddim_step(tpol.schedule, eps, int(t), int(p), x)
            _close(tpol._constrain(x, inpaint), want[i + 1], STEP_ATOL)


def test_sample_ddim_compat_100_matches(width8):
    jpol, jparams, tpol, tparams = width8
    rng = np.random.default_rng(2)
    batch = _window(rng, 2, 10)
    x_T = rng.uniform(size=(2, 31, 5)).astype(np.float32)
    want = jax.jit(partial(jpol.sample, sampler="ddim",
                           num_inference_steps=4, ddim_compat_100=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), init_noise=jnp.asarray(x_T))
    got = tpol.sample(tparams, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                      sampler="ddim", num_inference_steps=4,
                      ddim_compat_100=True, init_noise=torch.from_numpy(x_T))
    _close(got, want, CHAIN_ATOL)


def test_sample_amp_runs_bf16_and_keeps_inpaint(width8):
    _, _, tpol, tparams = width8
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(v) for k, v in _window(rng, 2, 10).items()}
    gen = torch.Generator().manual_seed(0)
    out = tpol.sample(tparams, batch, gen, sampler="ddim",
                      num_inference_steps=3, amp=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 31, 5)
    assert torch.isfinite(out).all()
    assert next(tparams["unet"].parameters()).dtype == torch.float32
    want = torch.cat([batch["position"][:, 9:10], batch["action"][:, 9:10]],
                     dim=-1)
    torch.testing.assert_close(out[:, :1], want, rtol=0, atol=0)


def _jax_ring_noise(cfg, uid, k0):
    """The x_T draws of the JAX ring policy (closed_loop.py's
    _init_noise_per_env with its default key)."""
    base = jax.random.key(0)
    draws = [jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(base, int(u)), k0),
        (cfg.horizon, cfg.prediction_dim)) for u in np.asarray(uid)]
    return np.stack([np.asarray(d) for d in draws])


def _ring_rollout(jpol, jparams, tpol, tparams, stats, n_envs, n_frames,
                  seed):
    """Run both ring policies on the same observation stream; returns the
    (frames, envs, 3) actions of each."""
    rng = np.random.default_rng(seed)
    jfn = jax.jit(jd.make_ring_policy(jpol, stats))
    tfn = td.make_ring_policy(
        tpol, stats,
        init_noise_fn=lambda uid, k0: torch.from_numpy(
            _jax_ring_noise(tpol.config, uid, k0)))
    jcarry = jd.init_ring_carry(jpol, n_envs)
    tcarry = td.init_ring_carry(tpol, n_envs)
    pos = rng.uniform(-50, 100, size=(n_envs, 2)).astype(np.float32)
    jout, tout = [], []
    for _ in range(n_frames):
        obs = rng.integers(0, 256, size=(n_envs, 96, 96, 3), dtype=np.uint8)
        vel = rng.uniform(-30, 30, size=(n_envs, 2)).astype(np.float32)
        pos = pos + 0.02 * vel
        res = Res(jnp.asarray(obs), Info(jnp.asarray(pos), jnp.asarray(vel)))
        ja, jcarry = jfn(jparams, jcarry, None, res)
        ta, tcarry = tfn(tparams, tcarry, torch.from_numpy(obs),
                         torch.from_numpy(pos), torch.from_numpy(vel))
        jout.append(np.asarray(ja))
        tout.append(ta.numpy())
    return np.stack(jout), np.stack(tout)


def test_ring_policy_matches_jax(width8):
    """8 envs x 12 frames: denoises at frames 0, 5, 10, queue rows between."""
    jpol, jparams, tpol, tparams = width8
    stats = load_stats(RUN_DIR / "STATS.pkl")
    want, got = _ring_rollout(jpol, jparams, tpol, tparams, stats, 8, 12, 4)
    assert got.shape == (12, 8, 3)
    assert np.abs(want).max() > 1e-3      # actions are not all zero
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


@pytest.mark.slow
def test_ring_policy_r5blend_full_width_matches_jax():
    """r5blend weights at full width, 8 envs x 50 frames (10 denoises)."""
    tpol, tparams, stats = load_run(str(RUN_DIR), device="cpu")
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(
        **dataclasses.asdict(tpol.config)))
    jparams = load_npz(str(RUN_DIR / "checkpoints" / "epoch=83" /
                           "params.npz"))
    want, got = _ring_rollout(jpol, jparams, tpol, tparams, stats, 8, 50, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


# ---------------------------------------------------------------------------
# isolation and devices
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tensorstore", "yaml",
              "orbax", "zstandard", "zarr", "numcodecs",
              "state_policy_diffusionmodel_tpu")
PORT_DIR = REPO / "state_policy_diffusionmodel_torch"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_policy.py",
        REPO / "tools" / "sweep_conv_plans.py"]
    assert len(files) > 10
    names = {str(f.relative_to(PORT_DIR)) for f in files
             if PORT_DIR in f.parents}
    assert {"physics/car.py", "track/geometry.py", "track/generator.py",
            "track/texture.py", "render/raster.py", "render/cuda_sampler.py",
            "envs/car_racing.py", "envs/vector.py", "bench.py",
            "models/cuda_ops.py", "kernels/build.py", "data/normalize.py",
            "data/replay_buffer.py", "data/dataset.py", "train/loop.py",
            "train/lr_schedule.py", "train/checkpoints.py",
            "utils/printing.py", "cli/train_policy.py", "control/pid.py",
            "control/drivers.py", "data/collect.py", "eval/rollout.py",
            "eval/suite.py", "train/sample_viz.py", "utils/plotting.py",
            "cli/generate_data.py", "cli/evaluate.py", "models/resnet.py",
            "models/autoencoder.py", "train/autoencoder.py",
            "cli/train_autoencoder.py", "data/native.py",
            "utils/profiling.py", "cli/sample.py", "cli/run_predictions.py",
            "cli/visualize_dataset.py", "cli/play.py", "cli/mfu.py",
            "sweeps.py", "parallel/mesh.py", "parallel/launch.py",
            "parallel/dryrun.py", "tools/merge_datasets.py",
            "tools/snapshot_run.py", "tools/make_resume_sidecar.py",
            "tools/make_shared_evalset.py"} <= names
    bad = {str(f.relative_to(REPO)): r for f in files
           for r in _imported_roots(f) if r in _FORBIDDEN}
    assert not bad
    # the CUDA sources: every one is built (chip_smoke.py builds SOURCES),
    # K3, K4 and K6 among them, and none includes PyTorch's or JAX's
    # headers
    from state_policy_diffusionmodel_torch.kernels import build

    cu = sorted(p.name for p in (PORT_DIR / "csrc").glob("*.cu"))
    assert cu == sorted(build.SOURCES.values())
    assert {"conv3x3.cu", "gn_act.cu", "conv_dw.cu"} <= set(cu)
    for name in cu:
        includes = [line for line in (PORT_DIR / "csrc" / name).read_text()
                    .splitlines() if line.startswith("#include")]
        assert not [i for i in includes if "torch" in i or "jax" in i
                    or "ATen" in i], (name, includes)
    # the shared headers (K3's and K6's conv_tile.cuh) likewise
    cuh = sorted(p.name for p in (PORT_DIR / "csrc").glob("*.cuh"))
    assert "conv_tile.cuh" in cuh
    for name in cuh:
        includes = [line for line in (PORT_DIR / "csrc" / name).read_text()
                    .splitlines() if line.startswith("#include")]
        assert not [i for i in includes if "torch" in i or "jax" in i
                    or "ATen" in i], (name, includes)


def test_port_import_loads_no_jax_module():
    mods = [f"state_policy_diffusionmodel_torch.{'.'.join(p.with_suffix('').relative_to(PORT_DIR).parts)}"
            for p in sorted(PORT_DIR.rglob("*.py")) if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    roots = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert "state_policy_diffusionmodel_torch" in roots
    assert not set(roots) & set(_FORBIDDEN)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = td.PolicyConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.DiffusionPolicy(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_run(str(RUN_DIR))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.make_schedule(1000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.make_obs_normalizers(None)
    assert td.DiffusionPolicy(cfg, device="cpu").device.type == "cpu"
    # the env, the renderer's inputs and the bench
    from state_policy_diffusionmodel_torch import bench, physics, track
    from state_policy_diffusionmodel_torch.cli import train_policy
    from state_policy_diffusionmodel_torch.cli import (
        train_autoencoder as cli_train_autoencoder,
    )
    from state_policy_diffusionmodel_torch.train import train_autoencoder
    from state_policy_diffusionmodel_torch.data import DeviceWindowDataset
    from state_policy_diffusionmodel_torch.envs import vector

    bank = track.load_or_build_bank(2, bake=False, device="cpu")
    ids = torch.arange(2, dtype=torch.int32)
    a = torch.zeros((2, 3))
    states = vector.init_batch(bank, ids, device="cpu")
    calls = [
        lambda: track.load_or_build_bank(2, bake=False),
        lambda: track.build(track.make_track(1), bake=False),
        lambda: physics.load_pickled_states(
            REPO / "tests" / "fixtures" / "golden_states.pkl"),
        lambda: vector.init_batch(bank, ids),
        lambda: vector.reset_batch(bank, track_ids=ids),
        lambda: vector.step_batch(states, bank, a, track_ids=ids),
        lambda: vector.rollout_constant(states, bank, a, 1, track_ids=ids),
        lambda: vector.rollout_policy(bank, None, None, 1, track_ids=ids),
        lambda: bench.bench_env(2, 1, 1, False, 2),
        lambda: bench.bench_policy(2, 1),
        lambda: bench.main(["--mode", "env_only"]),
        # the training path: the device twin, the trainer's policy, the CLI
        lambda: DeviceWindowDataset(None),
        lambda: train_policy.main(["--dataset_name", "none",
                                   "--no_sample_viz"]),
        # the autoencoder's trainer and CLI
        lambda: train_autoencoder(np.zeros((2, 96, 96, 3), np.float32),
                                  "none"),
        lambda: cli_train_autoencoder.main(["--dataset", "none"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the conv path's kernel wrappers (K3, K4, K5) take CUDA tensors only
    from state_policy_diffusionmodel_torch.models import cuda_ops

    x, w = torch.zeros((4, 16, 4, 8)), torch.zeros((8, 8, 3, 3))
    v, p = torch.zeros(8), torch.zeros((4, 8))
    for call in (lambda: cuda_ops.conv3x3_cuda(x, w),
                 lambda: cuda_ops.gn_act_cuda(x, v, v, p, p, x, True),
                 lambda: cuda_ops.double_conv_cuda(x, w, w, v, v, v, v, p,
                                                   p)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
