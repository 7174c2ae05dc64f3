"""The port's ResNet18GN, GroupNorm, UNetSimple and the ResNet-encoded
policy against the JAX package, on CPU; and `r4rn_best` through `load_run`.

The same inputs, made from a seeded numpy generator, go to both packages,
and flax parameters go to the port through the weight bridge. Everything
runs in float32 (the JAX tests pin float32 matmuls, and the port's convs
on the CPU have no TF32). x_T reaches both samplers through `init_noise`,
and the loss takes t and the noise as arguments, since torch cannot draw
JAX's threefry bits.

Tolerances:
- ResNet18GN features: 1e-5 absolute (features of order 1; the r4rn
  encoder reads ~7e-7: 20 convs summed in another order).
- GroupNorm: 1e-5 of the largest |output| on groups of mean up to 2 and
  std 0.5-3 (the fast variance amplifies f32's rounding of E[x^2] by
  E[x^2] / var, up to ~17 there). On a near-constant group
  (mean 0.1, std 3e-3, so E[x^2] / var ~ 1,100) flax's fast variance
  E[x^2] - E[x]^2 keeps ~1,100x f32's relative rounding, and the two
  packages sum in other orders: the output is held at 2e-3 of its largest
  |value|. torch's own `F.group_norm` (eps 1e-5) misses that by 30%
  there, and the test checks that it does.
- UNetSimple eps: 2e-5 absolute (two f32 U-Nets differ by ~4e-6, ROADMAP.md
  Queue 3 item 4). DDIM: each step from the JAX chain's own x_t at 2e-5,
  the 10-step chain at 2e-3 (tests/test_torch_policy.py's STEP_ATOL and
  CHAIN_ATOL, the same amplification by 1/sqrt(alpha-bar)).
- UNetSimple on the conv path: 3e-5 absolute, the DoubleConv bound of
  tests/test_torch_conv_path.py (JAX's `_dc_tpu` in Pallas interpret mode
  against the port's plain versions).
- The ResNet-encoded policy's loss: 1e-5 relative; the U-Net's and the
  encoder's gradients: 1e-4 of each tensor's largest |grad|, the rule of
  tests/test_torch_train.py (the eps difference carried back through the
  U-Net and 20 convs), in float64 (the test says why).
"""

import ast
import functools
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from jax.experimental import pallas as pl

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu.models import pallas_ops as po
from state_policy_diffusionmodel_tpu.models import resnet as jr
from state_policy_diffusionmodel_tpu.models import unet as ju
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.diffusion import schedules as ts
from state_policy_diffusionmodel_torch.models import cuda_ops
from state_policy_diffusionmodel_torch.models import layers as tlayers
from state_policy_diffusionmodel_torch.models import resnet as tr
from state_policy_diffusionmodel_torch.models import unet as tu
from state_policy_diffusionmodel_torch.params_from_jax import (
    encoder_from_jax, load_into, load_npz, params_from_jax, params_to_jax,
    unet_from_jax,
)

from test_torch_policy import torch_threads
from test_torch_train import _jax_loss

REPO = pathlib.Path(__file__).resolve().parents[1]
R4RN = REPO / "artifacts" / "r4rn_best"
FEAT_ATOL = 1e-5
GN_REL, GN_FAR_REL = 1e-5, 2e-3
EPS_ATOL, STEP_ATOL, CHAIN_ATOL, DC_ATOL = 2e-5, 2e-5, 2e-3, 3e-5
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4

_torch_threads = torch_threads(2)


def _np(rng, shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _draw(rng, shapes):
    """Parameters for a tree of shapes (`jax.eval_shape` of a flax init,
    which traces without compiling): kernels normal with std
    1/sqrt(fan_in), norm scales 1 and biases 0, each moved by 0.05 normal
    noise so that no layout slip hides behind a constant."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        shape = tuple(s.shape)
        if "kernel" in name:
            base = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            base = np.full(shape, 1.0 if "scale" in name else 0.0)
        return (base + 0.05 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _keyed(tree, top):
    return {f"['{top}']" + jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _round_trip_exact(module, top, tree):
    """params_to_jax of the loaded module gives back every leaf of `tree`
    bit for bit, and nothing else."""
    got = params_to_jax({top: module})
    want = _keyed(tree, top)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

def _flax_gn(groups, x, scale, bias):
    return np.asarray(nn.GroupNorm(num_groups=groups).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x)))


def _port_gn(groups, x, scale, bias):
    gn = tlayers.GroupNorm(groups, x.shape[-1])
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        return gn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("groups,C", [(1, 16), (4, 64), (32, 512)])
def test_group_norm_matches_flax(groups, C):
    rng = np.random.default_rng(groups)
    # each group its own mean and scale, so a group laid out on the wrong
    # channels shows
    x = _np(rng, (2, 6, 5, C)) * np.repeat(rng.uniform(0.5, 3, groups),
                                           C // groups).astype(np.float32)
    x += np.repeat(rng.uniform(-2, 2, groups), C // groups).astype(np.float32)
    scale, bias = _np(rng, (C,), 0.3, 1.0), _np(rng, (C,), 0.3)
    want = _flax_gn(groups, x, scale, bias)
    np.testing.assert_allclose(_port_gn(groups, x, scale, bias), want,
                               rtol=0, atol=GN_REL * np.abs(want).max())


def test_group_norm_near_constant_group_matches_flax():
    """A group whose variance (9e-6) is near eps: flax's eps 1e-6 against
    torch's 1e-5 moves its outputs by ~30%, which this holds; at this
    ratio of mean to std the fast and the two-pass variance agree within
    the tolerance, so the test does not tell them apart."""
    rng = np.random.default_rng(3)
    groups, C = 4, 64
    x = _np(rng, (2, 6, 6, C), 1.0)
    # group 1 near-constant: mean 0.1, std 3e-3 (var 9e-6, near eps)
    x[..., 16:32] = _np(rng, (2, 6, 6, 16), 3e-3, 0.1)
    scale, bias = np.ones(C, np.float32), np.zeros(C, np.float32)
    want = _flax_gn(groups, x, scale, bias)
    got = _port_gn(groups, x, scale, bias)
    tol = GN_FAR_REL * np.abs(want[..., 16:32]).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # torch's own group norm (eps 1e-5) is no match on that group
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    other = F.group_norm(xt, groups).permute(0, 2, 3, 1).numpy()
    assert np.abs(other - want)[..., 16:32].max() > 0.1 * np.abs(
        want[..., 16:32]).max()


def test_group_norm_bf16_keeps_f32_statistics():
    """Under amp the params and input are bf16: statistics in f32, the
    output rounded once to bf16, as flax promotes."""
    rng = np.random.default_rng(4)
    x = _np(rng, (2, 4, 4, 32), 2.0, 1.0)
    xb = torch.from_numpy(x).bfloat16()
    gn = tlayers.GroupNorm(2, 32).bfloat16()
    with torch.no_grad():
        got = gn(xb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(nn.GroupNorm(num_groups=2).apply(
        {"params": {"scale": jnp.ones(32, jnp.bfloat16),
                    "bias": jnp.zeros(32, jnp.bfloat16)}},
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)))
    assert want.dtype == jnp.bfloat16
    # one bf16 ulp of the output's scale
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=2 ** -7 * np.abs(
                                   want.astype(np.float32)).max())


# ---------------------------------------------------------------------------
# ResNet18GN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r4rn_tree():
    return load_npz(str(R4RN / "checkpoints" / "epoch=107" / "params.npz"))


def _resnet_forward_pair(tree, x):
    want = np.asarray(jax.jit(jr.ResNet18GN().apply)(
        {"params": tree}, jnp.asarray(x)))
    enc = encoder_from_jax(tree, "cpu")
    assert isinstance(enc, tr.ResNet18GN)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    return enc, got, want


def test_resnet18gn_r4rn_encoder_matches_jax(r4rn_tree):
    x = np.random.default_rng(5).uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32)
    enc, got, want = _resnet_forward_pair(r4rn_tree["encoder"], x)
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    _round_trip_exact(enc, "encoder", r4rn_tree["encoder"])


def test_resnet18gn_random_init_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    init = jax.eval_shape(jr.ResNet18GN().init, jax.random.key(1),
                          jnp.zeros((1, 96, 96, 3)))
    tree = _draw(rng, init["params"])
    enc, got, want = _resnet_forward_pair(tree, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    _round_trip_exact(enc, "encoder", tree)
    # the port's own init: flax's initializers leaf for leaf
    own = td.policy.init_module_(tr.ResNet18GN(), torch.Generator()
                                 .manual_seed(0))
    own_leaves = params_to_jax({"encoder": own})
    for k, v in _keyed(tree, "encoder").items():
        assert own_leaves[k].shape == v.shape, k
        if k.endswith("['scale']"):
            assert (own_leaves[k] == 1).all()
        elif k.endswith("['bias']"):
            assert (own_leaves[k] == 0).all()
        else:
            # lecun_normal: std sqrt(1 / fan_in) with fan_in = kh*kw*Cin
            fan_in = np.prod(v.shape[:-1])
            std = own_leaves[k].std()
            assert abs(std * np.sqrt(fan_in) - 1) < 0.25, (k, std)


# ---------------------------------------------------------------------------
# UNetSimple
# ---------------------------------------------------------------------------

def _unet_simple(rng, B, cond_dim, x, t, cond):
    jm = ju.build_model("UNet", time_dim=32, width=8)
    args = (jnp.asarray(x[:2]), jnp.asarray(t[:2]))
    if cond is not None:
        args += (jnp.asarray(cond[:2]),)
    return jm, _draw(rng, jax.eval_shape(jm.init, jax.random.key(0),
                                         *args)["params"])


@pytest.mark.parametrize("with_cond", [True, False])
def test_unet_simple_width8_matches_jax(with_cond):
    rng = np.random.default_rng(7)
    B, cond_dim = 3, 40
    x = _np(rng, (B, 31, 5, 1))
    t = np.array([0, 500, 999], np.int32)
    cond = _np(rng, (B, cond_dim)) if with_cond else None
    jm, params = _unet_simple(rng, B, cond_dim, x, t, cond)
    names = set(params)
    assert {f"DoubleConv_{i}" for i in range(13)} | {
        f"Dense_{i}" for i in range(6)} | {"Conv_0"} <= names
    assert ({f"_CondConcat_{i}" for i in range(6)} <= names) == with_cond
    args = [jnp.asarray(x), jnp.asarray(t)]
    targs = [torch.from_numpy(x), torch.from_numpy(t)]
    if with_cond:
        args.append(jnp.asarray(cond))
        targs.append(torch.from_numpy(cond))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *args))
    tm = unet_from_jax(params, "cpu")
    assert isinstance(tm, tu.UNetSimple) and tm.width == 8
    assert tm.use_cond == with_cond
    with torch.no_grad():
        got = tm(*targs).numpy()
    assert got.shape == (B, 31, 5, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=EPS_ATOL)
    _round_trip_exact(tm, "unet", params)
    # the registry builds the same net, its reference width 16 by default
    built = tu.build_model("UNet", cond_dim if with_cond else None,
                           time_dim=32, width=8)
    load_into(built, params)
    assert tu.build_model("UNet", cond_dim).width == 16
    with pytest.raises(ValueError, match="unknown model"):
        tu.build_model("UNet_Unknown", cond_dim)


def test_unet_simple_ddim_steps_match_jax():
    cfg = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
               inpaint_horizon=1, model="UNet", vision_encoder="autoencoder",
               step_size=5, model_width=8)
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**cfg))
    rng = np.random.default_rng(8)
    jparams = _draw(rng, jax.eval_shape(jpol.init_params, jax.random.key(0)))
    tpol = td.DiffusionPolicy(td.PolicyConfig(**cfg), device="cpu")
    tparams = params_from_jax(jparams, device="cpu")
    assert isinstance(tparams["unet"], tu.UNetSimple)
    B = 4
    batch = {"position": _np(rng, (B, 10, 2)), "velocity": _np(rng, (B, 10, 2)),
             "action": _np(rng, (B, 10, 3)),
             "image_features": _np(rng, (B, 10, 128))}
    x_T = rng.uniform(size=(B, 31, 5)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jpol.sample, sampler="ddim", num_inference_steps=10,
        ddim_spacing="trailing", history=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), init_noise=jnp.asarray(x_T)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tpol.sample(tparams, tbatch, sampler="ddim",
                      num_inference_steps=10, ddim_spacing="trailing",
                      history=True, init_noise=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    cond = tpol.obs_cond(tparams, tbatch)
    inpaint = tpol.inpaint_vector(tbatch)
    steps = ts.ddim_timesteps(1000, 10, "trailing")
    prev = list(steps[1:]) + [-1]
    with torch.no_grad():
        for i, (t, p) in enumerate(zip(steps, prev)):
            x = torch.tensor(want[i])
            eps = tparams["unet"](x[..., None], torch.full((B,), int(t)),
                                  cond)[..., 0]
            x = tpol._constrain(ts.ddim_step(tpol.schedule, eps, int(t),
                                             int(p), x), inpaint)
            np.testing.assert_allclose(x.numpy(), want[i + 1], rtol=0,
                                       atol=STEP_ATOL)


def test_unet_simple_conv_kernel_path_matches_jax(monkeypatch):
    """JAX with its conv kernels on (`_on_tpu` and `_PALLAS_CONV` patched
    true, Pallas in interpret mode) against the port with
    CONV_PATH="pallas". B=16: B*H*W >= 1024 at the 32x8 and 16x4 levels,
    so their six DoubleConvs with Cin >= 8 (three of them residual) go
    through `_dc_tpu`, the rest through `_double_conv_xla`."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(po, "_on_tpu", lambda: True)
    monkeypatch.setattr(po, "_PALLAS_CONV", True)
    rng = np.random.default_rng(9)
    B, cond_dim = 16, 40
    x = _np(rng, (B, 31, 5, 1))
    t = rng.integers(0, 1000, size=B).astype(np.int32)
    cond = _np(rng, (B, cond_dim))
    jm, params = _unet_simple(rng, B, cond_dim, x, t, cond)
    seen, dc_tpu = [], po._dc_tpu
    monkeypatch.setattr(po, "_dc_tpu", lambda *a: seen.append(
        (tuple(a[0].shape[1:3]), a[-1])) or dc_tpu(*a))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(cond))
    tm = unet_from_jax(params, "cpu")
    with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"), \
            torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(cond))
    assert len(seen) == 6 and sum(res for _, res in seen) == 3
    assert sorted({hw for hw, _ in seen}) == [(16, 4), (32, 8)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DC_ATOL)


# ---------------------------------------------------------------------------
# a UNetFiLM policy with a trained ResNet encoder: loss and gradients
# ---------------------------------------------------------------------------

def test_resnet_policy_train_encoder_grads_match_jax():
    """The loss and every gradient of a width-8 UNetFiLM policy with a
    trained ResNet18GN encoder, at fixed t and noise, in float64 on both
    sides (`jax.enable_x64`; the port's modules in double). In float32 a
    ReLU input within rounding of zero (one of the encoder's ~1.4 M at
    this batch; this seed has one at BasicBlock_7) takes either side in
    the two packages, and its mask moves every gradient upstream of it by
    up to ~1e-2 of the tensor's scale: a discontinuity, not a difference
    of the math. In float64 that needs an input within ~1e-16 of zero.
    The port's plain U-Net still rounds its norms, attention and convs
    through f32, so the rule stays 1e-4 of each tensor's largest |grad|."""
    cfg = dict(noise_steps=1000, obs_horizon=2, pred_horizon=14,
               inpaint_horizon=1, model="UNet_Film", vision_encoder="resnet18",
               step_size=1, model_width=8, train_encoder=True)
    jcfg, tcfg = jd.PolicyConfig(**cfg), td.PolicyConfig(**cfg)
    assert tcfg.observation_dim == jcfg.observation_dim == 519
    jpol = jd.DiffusionPolicy(jcfg)
    rng = np.random.default_rng(10)
    params = jax.tree.map(lambda p: p.astype(np.float64), _draw(
        rng, jax.eval_shape(jpol.init_params, jax.random.key(0))))
    B = 2
    batch = {"position": rng.normal(size=(B, 16, 2)),
             "velocity": rng.normal(size=(B, 16, 2)),
             "action": rng.normal(size=(B, 16, 3)),
             "image": rng.uniform(0, 1, (B, 2, 96, 96, 3))}
    t = rng.integers(0, 1000, B).astype(np.int32)
    noise = rng.normal(size=(B, 15, 5))
    with jax.enable_x64(True):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss(jpol, p, batch, t, noise)))(params)
        loss = float(loss)
        grads = jax.tree.map(np.asarray, grads)
    assert grads["encoder"]["Conv_0"]["kernel"].dtype == np.float64
    tpol = td.DiffusionPolicy(tcfg, device="cpu")
    tparams = {k: m.double() for k, m in
               params_from_jax(params, device="cpu").items()}
    assert isinstance(tparams["encoder"], tr.ResNet18GN)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = tpol.loss(tparams, tbatch, t=torch.from_numpy(t).long(),
                      noise=torch.from_numpy(noise))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), loss, rtol=LOSS_RTOL)
    want = _keyed(grads["unet"], "unet") | _keyed(grads["encoder"],
                                                  "encoder")
    got = params_to_jax(tparams, {p: p.grad for m in tparams.values()
                                  for p in m.parameters()})
    assert sorted(got) == sorted(want)
    assert len([k for k in want if k.startswith("['encoder']")]) == 60
    for k, w in want.items():
        if "['key']['bias']" in k:
            continue   # zero in exact arithmetic (tests/test_torch_train.py)
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


# ---------------------------------------------------------------------------
# r4rn_best through load_run
# ---------------------------------------------------------------------------

def test_load_run_r4rn_best_strict_without_jax():
    code = (
        "import sys\n"
        "from state_policy_diffusionmodel_torch.train import load_run\n"
        f"pol, params, stats = load_run({str(R4RN)!r}, device='cpu', "
        "ema=True)\n"
        "enc = params['encoder']\n"
        "print(repr([type(params['unet']).__name__, type(enc).__name__, "
        "params['unet'].width, pol.config.observation_dim, "
        "pol.config.feature_dim, sum(p.numel() for p in enc.parameters()), "
        "sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'optax'})]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    # ResNet-18 without its fc: 11.18 M parameters
    assert got[:5] == ["UNetFiLM", "ResNet18GN", 64, 519, 512]
    assert abs(got[5] - 11.18e6) < 0.01e6
    assert got[6] == []


@pytest.mark.slow
def test_r4rn_best_full_size_policy_eps_matches_jax(r4rn_tree):
    """r4rn_best at full size: the ResNet's features of the golden frames
    in a 10-frame window and the width-64 U-Net's eps on them (a 5,190-wide
    cond), against JAX. 5e-5: the full-width forward's bound of
    tests/test_torch_weights.py (flax's own forward lies ~2e-5 from a
    float64 run at these widths)."""
    with np.load(REPO / "tests" / "fixtures" / "golden_frames.npz") as d:
        frames = np.stack([d[f"f{i}_obs"] for i in range(6)]).astype(
            np.float32) / 255.0
    rng = np.random.default_rng(11)
    B = 2
    batch = {"position": _np(rng, (B, 40, 2), 0.5),
             "velocity": _np(rng, (B, 40, 2), 0.5),
             "action": _np(rng, (B, 40, 3), 0.5),
             "image": frames[rng.integers(0, 6, (B, 10))]}
    cfg = dict(model="UNet_Film", vision_encoder="resnet18",
               train_encoder=True)
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**cfg))
    tpol = td.DiffusionPolicy(td.PolicyConfig(**cfg), device="cpu")
    tparams = params_from_jax(r4rn_tree, device="cpu")
    x = rng.uniform(size=(B, 31, 5, 1)).astype(np.float32)
    t = np.array([900, 10], np.int32)

    def jax_eps(p, b):
        cond = jpol.obs_cond(p, b)
        return cond, jpol.unet.apply({"params": p["unet"]}, jnp.asarray(x),
                                     jnp.asarray(t), cond)
    cond, want = jax.jit(jax_eps)(r4rn_tree, batch)
    with torch.no_grad():
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        got_cond = tpol.obs_cond(tparams, tbatch)
        got = tparams["unet"](torch.from_numpy(x), torch.from_numpy(t),
                              got_cond)
    assert got_cond.shape == (B, 5190)
    np.testing.assert_allclose(got_cond.numpy(), np.asarray(cond), rtol=0,
                               atol=FEAT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)
