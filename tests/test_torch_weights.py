"""The weight bridge and the run-directory readers of the PyTorch port.

The r5blend checkpoint (`artifacts/r5blend_best`, fp16 npz of keystr
leaves) loads into the port at full width with every key consumed and
every shape matched; a full-width forward of its Encoder and UNetFiLM
matches the flax modules on the same weights and inputs.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu.models import autoencoder as jae
from state_policy_diffusionmodel_tpu.models import unet as ju
from state_policy_diffusionmodel_torch import params_from_jax as bridge
from state_policy_diffusionmodel_torch.models import Encoder, UNetFiLM
from state_policy_diffusionmodel_torch.train import checkpoints as ck

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "artifacts" / "r5blend_best"
NPZ = RUN_DIR / "checkpoints" / "epoch=83" / "params.npz"


@pytest.fixture(scope="module")
def r5blend_tree():
    return bridge.load_npz(str(NPZ))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_r5blend_bridge_consumes_every_key(r5blend_tree):
    with np.load(NPZ) as raw:
        keys = set(raw.files)
        assert len(keys) == 194
        assert {raw[k].dtype for k in keys} == {np.dtype(np.float16)}
    leaves = dict(_leaves(r5blend_tree))
    assert {"".join(f"['{p}']" for p in path) for path in leaves} == keys
    assert all(v.dtype == np.float32 for v in leaves.values())

    params = bridge.params_from_jax(r5blend_tree, device="cpu")
    unet, enc = params["unet"], params["encoder"]
    assert (unet.width, unet.time_dim, unet.with_attention) == (64, 256, True)
    n_torch = len(unet.state_dict()) + len(enc.state_dict())
    assert n_torch == 194
    # spot-check the three layout maps against the raw fp16 arrays
    with np.load(NPZ) as raw:
        k = raw["['unet']['DownBlock_0']['DoubleConv_0']['conv1_kernel']"]
        np.testing.assert_array_equal(
            unet.DownBlock_0.DoubleConv_0.conv1_kernel.detach().numpy(),
            k.astype(np.float32).transpose(3, 2, 0, 1))
        q = raw["['unet']['SelfAttention_1']"
                "['MultiHeadDotProductAttention_0']['query']['kernel']"]
        np.testing.assert_array_equal(
            unet.SelfAttention_1.MultiHeadDotProductAttention_0.query.weight
            .detach().numpy(), q.astype(np.float32).reshape(256, 256).T)
        d = raw["['encoder']['Dense_0']['kernel']"]
        np.testing.assert_array_equal(enc.Dense_0.weight.detach().numpy(),
                                      d.astype(np.float32).T)


def test_bridge_raises_on_left_over_missing_and_misshapen(r5blend_tree):
    enc_tree = r5blend_tree["encoder"]
    extra = dict(enc_tree, Dense_9={"bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="left over .*Dense_9"):
        bridge.load_into(Encoder(128), extra)
    missing = {k: v for k, v in enc_tree.items() if k != "Conv_2"}
    with pytest.raises(ValueError, match="missing .*Conv_2"):
        bridge.load_into(Encoder(128), missing)
    bad = dict(enc_tree, Dense_0={"kernel": np.zeros((9216, 64), np.float32),
                                  "bias": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="shapes differ"):
        bridge.load_into(Encoder(128), bad)
    with pytest.raises(ValueError, match="top-level"):
        bridge.params_from_jax(dict(r5blend_tree, opt={}), device="cpu")


def test_parse_keystr():
    assert bridge.parse_keystr("['unet']['Conv_0']['kernel']") == (
        "unet", "Conv_0", "kernel")
    with pytest.raises(ValueError):
        bridge.parse_keystr("['unet'].Conv_0")


def test_load_hparams_and_stats(tmp_path):
    hp = ck.load_hparams(str(RUN_DIR / "hparams.yaml"))
    assert hp["model"] == "UNet_Film" and hp["model_width"] is None
    assert hp["train_min_lr"] == 1e-6 and hp["uniform_init"] is True
    assert hp["noise_steps"] == 1000 and hp["train_lr"] == 0.0004
    assert hp["train_insurance_dir"] == "artifacts/r5blend_best"
    p = tmp_path / "hparams.yaml"
    p.write_text("a: -3\nb: .5\nc: 'x: y'\nd: false\ne: ~\nf: 2.0E+3\n")
    assert ck.load_hparams(str(p)) == {"a": -3, "b": 0.5, "c": "x: y",
                                       "d": False, "e": None, "f": 2000.0}
    p.write_text("a:\n  b: 1\n")
    with pytest.raises(ValueError, match="flat"):
        ck.load_hparams(str(p))
    stats = ck.load_stats(str(RUN_DIR / "STATS.pkl"))
    assert set(stats) == {"position", "velocity", "action"}
    assert np.asarray(stats["action"]["max"]).shape == (3,)
    assert ck.latest_checkpoint(str(RUN_DIR)).endswith("epoch=83")
    assert ck.latest_checkpoint(str(tmp_path)) is None


def test_load_run_assembles_policy(r5blend_tree):
    policy, params, stats = ck.load_run(str(RUN_DIR), device="cpu")
    assert policy.config.model == "UNet_Film"
    assert policy.config.observation_dim == 135
    assert isinstance(params["unet"], UNetFiLM)
    assert isinstance(params["encoder"], Encoder)
    assert stats["position"]["min"] < stats["position"]["max"]


def test_load_run_ema_finds_the_ema_weights(tmp_path):
    """`--ema`: checkpoints_ema/ when the run has it; else an exported best
    run whose BEST.json says its checkpoints are the EMA weights (r5blend);
    else an error."""
    assert ck.ema_subdir(str(RUN_DIR)) == "checkpoints"
    _, ema, _ = ck.load_run(str(RUN_DIR), device="cpu", ema=True)
    _, raw, _ = ck.load_run(str(RUN_DIR), device="cpu")
    for a, b in zip(ema["unet"].state_dict().values(),
                    raw["unet"].state_dict().values()):
        assert torch.equal(a, b)
    (tmp_path / "checkpoints_ema").mkdir()
    assert ck.ema_subdir(str(tmp_path)) == "checkpoints_ema"
    with pytest.raises(FileNotFoundError, match="no EMA"):
        ck.ema_subdir(str(tmp_path / "checkpoints_ema"))


def test_r5blend_full_width_forward_matches_jax(r5blend_tree):
    """One full-width forward of each net with the r5blend weights."""
    rng = np.random.default_rng(0)
    params = bridge.params_from_jax(r5blend_tree, device="cpu")

    img = rng.uniform(size=(2, 96, 96, 3)).astype(np.float32)
    want = jae.Encoder(128).apply({"params": r5blend_tree["encoder"]},
                                  jnp.asarray(img))
    with torch.no_grad():
        got = params["encoder"](torch.from_numpy(img))
    # latents reach |11| and come from 9216-term f32 sums: 2e-6 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-5)

    x = rng.uniform(size=(2, 31, 5, 1)).astype(np.float32)
    t = np.array([900, 10], np.int32)
    cond = rng.normal(size=(2, 1350)).astype(np.float32) * 0.5
    want = jax.jit(ju.UNetFiLM().apply)(
        {"params": r5blend_tree["unet"]}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(cond))
    with torch.no_grad():
        got = params["unet"](torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(cond))
    # full width sums up to 4608 terms per conv output through 22 convs:
    # the flax forward itself lies 2.2e-5 from a float64 run of these
    # weights and inputs (the port 4.9e-6), so 5e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)
