"""The port's Decoder, Autoencoder, autoencoder trainer and CLI against the
JAX package, on CPU.

The same inputs go to both packages: the golden frames of
tests/fixtures/golden_frames.npz, or frames made from a seeded numpy
generator at exact 8-bit levels; flax parameters go to the port through
the weight bridge. The trainers start from the same parameters: the JAX
trainer's own init (`Autoencoder().init` at `jax.random.key(seed)`),
handed to the port as `init`.

Tolerances:
- reconstructions and latents: 1e-5 absolute (sigmoid outputs in (0, 1);
  latents of order 10 at 2e-5: three convs and a 9,216-wide Dense summed
  in another order).
- the trainer: every step's loss at 1e-4 relative and the epoch's val loss
  at 1e-4 relative. The two packages' gradients differ by f32 rounding,
  and Adam's first update g / (|g| + 1e-8) turns that into up to 2 lr on
  a parameter whose g is near zero (ROADMAP.md Queue 3 item 4); the
  losses after a few steps carry it.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from state_policy_diffusionmodel_tpu.models import autoencoder as ja
from state_policy_diffusionmodel_tpu.train import autoencoder as jtae
from state_policy_diffusionmodel_tpu.train import checkpoints as jck
from state_policy_diffusionmodel_torch.cli import train_autoencoder as tcli
from state_policy_diffusionmodel_torch.cli import train_policy as tpcli
from state_policy_diffusionmodel_torch.data import ReplayBuffer, save_zarr
from state_policy_diffusionmodel_torch.models import Autoencoder, Decoder
from state_policy_diffusionmodel_torch.models import layers as tlayers
from state_policy_diffusionmodel_torch.params_from_jax import (
    load_into, load_npz, params_to_jax,
)
from state_policy_diffusionmodel_torch.train import autoencoder as ttae

from test_torch_policy import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
R3 = REPO / "artifacts" / "r3_autoencoder" / "checkpoints" / "epoch=19"
GOLDEN = REPO / "tests" / "fixtures" / "golden_frames.npz"
RECON_ATOL, LATENT_ATOL = 1e-5, 2e-5
LOSS_RTOL = 1e-4

_torch_threads = torch_threads(2)


def _golden():
    with np.load(GOLDEN) as d:
        return np.stack([d[k] for k in sorted(d.files)]).astype(
            np.float32) / 255.0


def _keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _frames(rng, n):
    """n smooth frames at exact 8-bit levels: 12x12 noise blown up 8x."""
    low = rng.integers(0, 256, (n, 12, 12, 3)).astype(np.uint8)
    return np.repeat(np.repeat(low, 8, 1), 8, 2)


def test_r3_autoencoder_reconstructs_the_golden_frames_as_jax():
    tree = load_npz(str(R3 / "params.npz"))
    x = _golden()
    assert x.shape == (12, 96, 96, 3)
    jae = ja.Autoencoder()
    want = np.asarray(jax.jit(jae.apply)({"params": tree}, jnp.asarray(x)))
    want_z = np.asarray(jax.jit(lambda p, x: jae.apply(
        {"params": p}, x, method=ja.Autoencoder.encode))(tree, jnp.asarray(x)))
    ae = load_into(Autoencoder(), tree)
    with torch.no_grad():
        z = ae.encode(torch.from_numpy(x))
        got = ae(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0, atol=LATENT_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RECON_ATOL)
    # a trained AE: closer to the frames than their mean color is
    assert np.mean((want - x) ** 2) < 0.5 * np.mean((x - x.mean((0, 1, 2)))
                                                   ** 2)
    # the bridge's round trip is exact
    leaves = params_to_jax({"encoder": ae.encoder, "decoder": ae.decoder})
    flat = {"['encoder']" + k: v for k, v in _keyed(tree["encoder"]).items()}
    flat.update({"['decoder']" + k: v
                 for k, v in _keyed(tree["decoder"]).items()})
    assert sorted(leaves) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)


def test_conv_transpose_bridge_flips_the_kernel():
    """flax's ConvTranspose (transpose_kernel=False) is torch's transposed
    conv with the kernel flipped in both spatial axes: the bridge loads a
    random flax kernel so, and the unflipped kernel is far off on the same
    input."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    m = nn.ConvTranspose(5, (2, 2), strides=(2, 2))
    params = jax.tree.map(np.asarray, m.init(jax.random.key(0),
                                              jnp.asarray(x))["params"])
    params["bias"] = rng.normal(size=5).astype(np.float32)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ConvTranspose_0 = tlayers.ConvTranspose(8, 5, 2, 2)

    one = load_into(One(), {"ConvTranspose_0": params})
    with torch.no_grad():
        got = one.ConvTranspose_0(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RECON_ATOL)
    back = params_to_jax({"m": one})["['m']['ConvTranspose_0']['kernel']"]
    np.testing.assert_array_equal(back, params["kernel"])
    with torch.no_grad():
        one.ConvTranspose_0.weight.copy_(torch.from_numpy(
            params["kernel"].transpose(2, 3, 0, 1).copy()))
        unflipped = one.ConvTranspose_0(torch.from_numpy(x)).numpy()
    assert np.abs(unflipped - want).max() > 100 * RECON_ATOL


def test_decoder_random_init_matches_jax():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(3, 128)).astype(np.float32)
    init = jax.jit(ja.Decoder().init)(jax.random.key(3), jnp.asarray(z))
    want = np.asarray(ja.Decoder().apply(init, jnp.asarray(z)))
    dec = load_into(Decoder(), jax.tree.map(np.asarray, init["params"]))
    with torch.no_grad():
        got = dec(torch.from_numpy(z)).numpy()
    assert got.shape == (3, 96, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RECON_ATOL)


class _CaptureEpochLosses:
    """Stands in for `jax` in the JAX trainer's module: jits as jax does,
    and keeps the per-step losses `run_epoch` returns."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)
        if fn.__name__ != "run_epoch":
            return jitted

        def run(*args):
            out = jitted(*args)
            self.losses.extend(np.asarray(out[2]).tolist())
            return out
        return run


@pytest.mark.parametrize("batch_size", [32, 16])
def test_train_autoencoder_epoch_matches_jax(tmp_path, monkeypatch,
                                             batch_size):
    """One epoch on 300 frames from the JAX trainer's initial params: the
    split and the order (one default_rng(seed)), every step's loss, the
    val loss (30 val frames: one ragged batch at batch 32, one full batch
    of 16 at 16) and the plateau's lr."""
    images = _frames(np.random.default_rng(4), 300).astype(np.float32) / 255
    seed = 5
    capture = _CaptureEpochLosses()
    monkeypatch.setattr(jtae, "jax", capture)
    logs = []
    want = jtae.train_autoencoder(images, str(tmp_path / "jax"), epochs=1,
                                  batch_size=batch_size, lr=1e-3, seed=seed,
                                  log=logs.append)
    monkeypatch.undo()
    init = jax.device_get(jax.jit(ja.Autoencoder().init)(
        jax.random.key(seed), jnp.zeros((1, 96, 96, 3)))["params"])
    got = ttae.train_autoencoder(images, str(tmp_path / "torch"), epochs=1,
                                 batch_size=batch_size, lr=1e-3, seed=seed,
                                 log=logs.append, device="cpu", init=init)
    h = got["history"]
    assert len(h["step_loss"]) == len(capture.losses) == 270 // batch_size
    np.testing.assert_allclose(h["step_loss"], capture.losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(h["train_loss"], want["history"]["train_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(h["val_loss"], want["history"]["val_loss"],
                               rtol=LOSS_RTOL)
    assert h["lr"] == [1e-3]
    # each epoch's {'encoder', 'decoder'} npz, readable by the JAX package
    ck = tmp_path / "torch" / "checkpoints" / "epoch=0" / "params.npz"
    like = jax.device_get(init)
    loaded = jck.load_checkpoint(str(ck.parent), like)
    mine = params_to_jax(ttae.autoencoder_params(got["params"]))
    for k, v in _keyed(loaded).items():
        np.testing.assert_array_equal(v, mine[k])


def _store(path, rng, n_frames=(150, 150)):
    buf = ReplayBuffer()
    for n in n_frames:
        buf.add_episode({
            "img": _frames(rng, n),
            "position": np.cumsum(rng.normal(size=(n, 2)), 0)
            .astype(np.float32),
            "velocity": rng.normal(size=(n, 2)).astype(np.float32),
            "action": rng.uniform(-1, 1, (n, 3)).astype(np.float32)})
    save_zarr(buf, path)


def test_cli_trains_evaluates_and_its_run_feeds_the_policy_clis(tmp_path,
                                                                capsys):
    data = str(tmp_path / "ds.zarr")
    _store(data, np.random.default_rng(6))
    with open(os.path.join(data, "data", "img", ".zarray")) as f:
        assert '"zlib"' in f.read()
    res = tcli.main(["--dataset", data, "--epochs", "1", "--batch_size",
                     "64", "--out_dir", str(tmp_path / "runs"), "--version",
                     "v", "--device", "cpu"])
    run = tmp_path / "runs" / "v"
    assert res["out_dir"] == str(run)
    assert np.isfinite(res["history"]["train_loss"]).all()
    assert np.isfinite(res["history"]["val_loss"]).all()
    ev = tcli.main(["--dataset", data, "--eval_run", str(run), "--n_eval",
                    "4", "--device", "cpu"])
    assert os.path.getsize(run / "reconstructions.png") > 0
    assert "reconstruction MSE" in capsys.readouterr().out
    assert 0 < ev["mse"] < 0.2
    # the port's --encoder_ckpt takes the run, and so does the JAX CLI's
    # loader (its template load of the newest epoch)
    path, enc = tpcli.load_encoder_tree(str(run))
    assert path.endswith("epoch=0") and "Dense_0" in enc
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        ja.Autoencoder().init, jax.random.key(0), jnp.zeros((1, 96, 96, 3))
    )["params"])
    loaded = jck.load_checkpoint(jck.latest_checkpoint(str(run)), tmpl)
    mine = params_to_jax(ttae.autoencoder_params(res["params"]))
    for k, v in _keyed(loaded).items():
        np.testing.assert_array_equal(v, mine[k])
