"""The port's offline sampling CLI (`cli/sample.py`) against the JAX
package's, on CPU, and the denoising animations.

A tiny run (UNet_Film at model_width 8 with the conv-AE encoder, obs 4 /
pred 6 / inpaint 1 / step 2, random weights saved in the JAX npz form) and
a tiny zarr store of synthetic episodes stand in for a trained run and its
dataset. Both packages load the run, take the first validation window of
their DataModule (the same window: the batches are compared exactly) and
sample it with the history kept, fed the same x_T (`init_noise`; torch
cannot draw JAX's threefry numbers). Tolerances are test_torch_policy.py's:
a DDIM step from the JAX chain's own x_t within STEP_ATOL = 2e-5, a
10-step DDIM or DPM++ history within CHAIN_ATOL = 2e-3 (two float32 U-Nets
differ by ~4e-6 in eps, which the chain amplifies by up to 1/sqrt(a_t)).
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu import train as jtrain
from state_policy_diffusionmodel_tpu.data import dataset as jds
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.cli import sample as tcli
from state_policy_diffusionmodel_torch.data import ReplayBuffer, save_zarr
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.diffusion import schedules as ts
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.train import load_run

from test_torch_policy import CHAIN_ATOL, STEP_ATOL, torch_threads

CFG = dict(noise_steps=1000, obs_horizon=4, pred_horizon=6,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="autoencoder",
           step_size=2, model_width=8)

_torch_threads = torch_threads(2)


def write_episodes(path, seed=0, lengths=(60, 70)):
    """A zarr store of synthetic episodes (uint8 frames, a random walk)."""
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer()
    for L in lengths:
        buf.add_episode({
            "img": rng.integers(0, 256, (L, 96, 96, 3), dtype=np.uint8),
            "position": np.cumsum(rng.normal(size=(L, 2)), 0)
            .astype(np.float32) * 3,
            "velocity": rng.normal(size=(L, 2)).astype(np.float32),
            "action": rng.uniform(-1, 1, (L, 3)).astype(np.float32)})
    save_zarr(buf, str(path))
    return buf


def write_run(run, data, cfg=CFG, epochs=(3,), seed=0, ema=True):
    """A run dir in the trainer's layout: random weights (perturbed so no
    layer is zero) at each of `epochs`, the EMA copy of the last, hparams
    and the stats of `data`'s windows. Returns {epoch: params}."""
    cfg = td.PolicyConfig(**cfg)
    pol = td.DiffusionPolicy(cfg, "cpu")
    out = {}
    for i, epoch in enumerate(epochs):
        gen = torch.Generator().manual_seed(seed + i)
        params = pol.init_params(gen)
        with torch.no_grad():
            for m in params.values():
                for p in m.parameters():
                    p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        tck.save_checkpoint(str(run), params, epoch)
        if ema:
            tck.save_checkpoint(str(run), params, epoch,
                                subdir="checkpoints_ema")
        out[epoch] = params
    tck.save_hparams(str(run), cfg)
    ds = tds.WindowDataset(data, cfg.obs_horizon, cfg.pred_horizon,
                           cfg.step_size)
    tds.save_stats(ds.stats, os.path.join(str(run), "STATS.pkl"))
    return out


def jax_run(run, cfg=CFG, epoch=None):
    """(JAX policy, params) of the run, through the JAX package's loaders."""
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**cfg))
    tmpl = jpol.init_params(jax.random.key(0))
    ckpt = (jtrain.checkpoints.latest_checkpoint(str(run)) if epoch is None
            else os.path.join(str(run), "checkpoints", f"epoch={epoch}"))
    return jpol, jtrain.checkpoints.load_checkpoint(ckpt, tmpl)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("sample")
    data = write_episodes(root / "ds.zarr")
    write_run(root / "run", data)
    # a 40-step schedule, for DDPM, which runs every step of it
    write_run(root / "run40", data, dict(CFG, noise_steps=40), ema=False)
    return root


@pytest.mark.parametrize("sampler,spacing", [("DDIM", "leading"),
                                             ("DPMPP", "trailing")])
def test_sample_history_matches_jax(tiny, sampler, spacing):
    policy, params, stats = load_run(str(tiny / "run"), "cpu")
    batch = tcli.load_window(policy, stats, str(tiny), "ds.zarr",
                             split_seed=7)
    jpol, jparams = jax_run(tiny / "run")
    dm = jds.DataModule(batch_size=1, data_dir=str(tiny), T_obs=4, T_pred=6,
                        seed=7,
                        stats=jds.load_stats(str(tiny / "run" / "STATS.pkl")),
                        step_size=2)
    dm.setup("ds.zarr")
    jbatch = dm.data_full.batch(dm.val_idx[:1])
    # the same window, exactly (the image frames the conditioning reads)
    for k, v in batch.items():
        assert np.array_equal(v.numpy(), np.asarray(jbatch[k])[:, :v.shape[1]])
    x_T = np.random.default_rng(5).uniform(size=(1, 7, 5)).astype(np.float32)
    got = tcli.sample_history(policy, params, batch, sampler, 10, spacing,
                              init_noise=torch.from_numpy(x_T))
    assert tuple(got.shape) == (11, 1, 7, 5)
    want = np.asarray(jax.jit(partial(
        jpol.sample, sampler=tcli.SAMPLERS[sampler], num_inference_steps=10,
        ddim_spacing=spacing, history=True))(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()},
        jax.random.key(0), init_noise=jnp.asarray(x_T)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    # the last row is the sample without history, at the same x_T
    last = policy.sample(params, batch, sampler=tcli.SAMPLERS[sampler],
                         num_inference_steps=10, ddim_spacing=spacing,
                         init_noise=torch.from_numpy(x_T))
    assert torch.equal(last, got[-1])
    if sampler != "DDIM":
        return
    # each DDIM step from the JAX chain's own x_t
    cond = policy.obs_cond(params, batch)
    inpaint = policy.inpaint_vector(batch)
    steps = ts.ddim_timesteps(1000, 10, spacing)
    prev = list(steps[1:]) + [-1]
    with torch.no_grad():
        for i, (t, p) in enumerate(zip(steps, prev)):
            x = torch.tensor(want[i])
            eps = params["unet"](x[..., None], torch.full((1,), int(t)),
                                 cond)[..., 0]
            x = ts.ddim_step(policy.schedule, eps, int(t), int(p), x)
            np.testing.assert_allclose(
                policy._constrain(x, inpaint).numpy(), want[i + 1], rtol=0,
                atol=STEP_ATOL)


def test_sample_main_writes_both_animations(tiny, tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    hist, paths = tcli.main([
        "--run_dir", str(tiny / "run"), "--ema", "--gaussian_init",
        "--dataset_dir", str(tiny), "--dataset_name", "ds.zarr",
        "--model_name", "DDIM", "--num_inference_steps", "12",
        "--out_dir", str(tmp_path), "--device", "cpu"])
    assert hist.shape == (13, 1, 7, 5) and np.isfinite(hist).all()
    assert [os.path.basename(p).split(".")[0] for p in paths] == [
        "DDIM_positions", "DDIM_actions"]
    from PIL import Image

    for p in paths:
        assert os.path.getsize(p) > 0
        with Image.open(p) as im:
            assert im.n_frames == 2          # steps 0 and 10 of 12
    # the frames are the JAX package's figures of the same history
    from state_policy_diffusionmodel_tpu.utils import plotting as jplot
    from state_policy_diffusionmodel_torch.utils import plotting as tplot

    for kind in ("positions", "actions"):
        got = tplot.denoising_frames(hist, kind=kind)
        want = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jplot, "save_animation",
                       lambda frames, path, fps: want.extend(frames))
            jplot.denoising_animation(hist, "unused.gif", kind=kind)
        assert len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # without a card the CLI raises, naming the device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--run_dir", str(tiny / "run"), "--dataset_name",
                       "ds.zarr"])


def test_sample_ddpm_keeps_every_step(tiny):
    """DDPM runs every step of the run's schedule (40 here) whatever
    --num_inference_steps says, as the JAX sampler does, and its noise
    comes from the seeded generator."""
    policy, params, stats = load_run(str(tiny / "run40"), "cpu")
    batch = tcli.load_window(policy, stats, str(tiny), "ds.zarr")
    hist = tcli.sample_history(policy, params, batch, "DDPM", 100, seed=3)
    assert tuple(hist.shape) == (41, 1, 7, 5)
    assert torch.isfinite(hist).all()
    again = tcli.sample_history(policy, params, batch, "DDPM", 100, seed=3)
    assert torch.equal(hist, again)
