"""The port's bf16 (amp) path against the JAX package's, on CPU.

Under amp both packages cast every parameter and every float input to
bfloat16, run the nets in bf16 (norm statistics in f32) and keep the
scheduler math in f32. The same inputs, made from a seeded numpy generator,
go to both: at model_width=8 with random weights, and at full width with
r5blend's weights (`artifacts/r5blend_best`).

Tolerance, in bf16 ulps of the output's scale (one ulp is 2**-7 * max|x|):
each package's bf16 forward lies 1.5-3.4 ulps from its own fp32 forward
(the roundings of ~60 layers), and the two packages round at different
points of some layers (a matmul's output, a conv's), so their bf16
forwards lie as far apart as each lies from fp32. The port is held within
TOL_ULPS = 6 of the JAX bf16 forward and of the JAX fp32 forward (about
twice the widest reading, width 8: 3.2 and 3.4 ulps). A DDIM step moves
eps's difference into x by the step's eps coefficient, which the step's
bound carries.
"""

import dataclasses
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.diffusion import schedules as ts
from state_policy_diffusionmodel_torch.params_from_jax import (
    load_npz, params_from_jax,
)
from state_policy_diffusionmodel_torch.train import load_run

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "artifacts" / "r5blend_best"
NPZ = RUN_DIR / "checkpoints" / "epoch=83" / "params.npz"
TOL_ULPS = 6
BF16_ULP = 2 ** -7


@pytest.fixture(scope="module", params=["width8", "r5blend"])
def policies(request):
    """(jax policy, jax params, torch policy, torch params) on one set of
    weights."""
    if request.param == "r5blend":
        tpol, tparams, _ = load_run(str(RUN_DIR), device="cpu")
        jparams = load_npz(str(NPZ))
    else:
        cfg = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
                   inpaint_horizon=1, model="UNet_Film",
                   vision_encoder="autoencoder", step_size=5, model_width=8)
        tpol = td.DiffusionPolicy(td.PolicyConfig(**cfg), device="cpu")
        jpol = jd.DiffusionPolicy(jd.PolicyConfig(**cfg))
        rng = np.random.default_rng(0)
        jparams = jax.tree.map(
            lambda p: np.asarray(p, np.float32)
            + (rng.normal(size=p.shape) * 0.02).astype(np.float32),
            jpol.init_params(jax.random.key(0)))
        tparams = params_from_jax(jparams, device="cpu")
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(
        **dataclasses.asdict(tpol.config)))
    return jpol, jparams, tpol, tparams


def _inputs(seed, B=2, T=10, latent=128):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    batch = {"position": f(B, T, 2), "velocity": f(B, T, 2),
             "action": f(B, T, 3), "image_features": f(B, T, latent)}
    x_T = rng.uniform(size=(B, 31, 5)).astype(np.float32)
    return batch, x_T


def _ulps(got, want, scale):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max()
                 / (BF16_ULP * scale))


def _unet_eps(jpol, jparams, tpol, tparams, batch, x, t):
    """eps of both U-Nets at (x, t) on the window's cond: (port bf16, JAX
    bf16, JAX fp32), each as f32 numpy."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B = x.shape[0]
    t_b = np.full((B,), t, np.int32)

    def jax_eps(params, dt):
        params = jax.tree.map(lambda v: v.astype(dt), params)
        cond = jpol.obs_cond(params, {k: v.astype(dt) for k, v in jb.items()})
        out = jax.jit(jpol.unet.apply)({"params": params["unet"]},
                                       jnp.asarray(x, dt)[..., None],
                                       jnp.asarray(t_b), cond)
        return np.asarray(out[..., 0].astype(jnp.float32))

    p16 = td.policy.cast_params(tparams, torch.bfloat16)
    with torch.no_grad():
        cond = tpol.obs_cond(p16, {k: v.bfloat16() for k, v in tb.items()})
        got = p16["unet"](torch.from_numpy(x).bfloat16()[..., None],
                          torch.from_numpy(t_b).long(), cond)
    assert got.dtype == torch.bfloat16
    return (got[..., 0].float().numpy(),
            jax_eps(jparams, jnp.bfloat16), jax_eps(jparams, jnp.float32))


def test_unet_forward_bf16_matches_jax(policies):
    jpol, jparams, tpol, tparams = policies
    batch, x_T = _inputs(1)
    got, want16, want32 = _unet_eps(jpol, jparams, tpol, tparams, batch,
                                    x_T, 900)
    scale = np.abs(want16).max()
    assert _ulps(got, want16, scale) <= TOL_ULPS
    assert _ulps(got, want32, scale) <= TOL_ULPS


def test_ddim_step_bf16_matches_jax(policies):
    """The first step of DDIM-10 (leading, t 900 -> 800) under amp through
    each package's `sample`, x_T injected. The bound is TOL_ULPS of eps's
    scale times the step's eps coefficient
    sqrt(1 - a_prev) - sqrt(a_prev) * sqrt(1 - a) / sqrt(a), plus 1e-5 for
    the f32 step math."""
    jpol, jparams, tpol, tparams = policies
    batch, x_T = _inputs(2)
    want = np.asarray(jax.jit(partial(
        jpol.sample, sampler="ddim", num_inference_steps=10, amp=True,
        history=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(0), init_noise=jnp.asarray(x_T)))
    got = tpol.sample(tparams, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                      sampler="ddim", num_inference_steps=10, amp=True,
                      history=True, init_noise=torch.from_numpy(x_T))
    assert got.dtype == torch.float32 and tuple(got.shape) == (11, 2, 31, 5)
    t, prev = ts.ddim_timesteps(1000, 10, "leading")[:2]
    assert (t, prev) == (900, 800)
    a = float(tpol.schedule.alphas_cumprod[t])
    a_prev = float(tpol.schedule.alphas_cumprod[prev])
    coef = abs(np.sqrt(1 - a_prev) - np.sqrt(a_prev) * np.sqrt(1 - a)
               / np.sqrt(a))
    x_t = want[0]
    np.testing.assert_array_equal(got[0].numpy(), x_t)
    _, eps16, _ = _unet_eps(jpol, jparams, tpol, tparams, batch, x_t, t)
    bound = TOL_ULPS * BF16_ULP * np.abs(eps16).max() * coef + 1e-5
    assert np.abs(got[1].numpy() - want[1]).max() <= bound
