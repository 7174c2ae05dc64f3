"""The port's conv path (plain versions of K3, K4 and K5, and its selector)
against the JAX package's Pallas conv kernels, on CPU.

The Pallas kernels run in TPU interpret mode (monkeypatched `pallas_call`,
as tests/test_pallas_ops.py runs them); the port runs its plain PyTorch
versions, which is what CPU tensors take on every conv path. The same
inputs, made from a seeded numpy generator, go to both; bf16 inputs are
numpy float32 values rounded to bf16 once and handed to both as bf16.

Tolerances:
- float32: 1e-5 absolute at these sizes (outputs of order 1-5), as
  tests/test_torch_layers.py holds the XLA formulations; the DoubleConv
  cases at 3e-5, the bound `test_double_conv_pallas_matches_xla` holds
  `_dc_tpu` to.
- bfloat16: one bf16 ulp of the output's scale, max |got - want| <= 2**-7 *
  max |want| (2**-7 is one ulp at the top binade). Rounding two f32 values
  that differ in summation order, or by the TPU kernel's rational erf
  (1.5e-7), to bf16 differs by at most one ulp of the value. DoubleConv
  rounds four times in a chain; an ulp flipped in its intermediate reaches
  the output through the second conv's sum and norm, attenuated (these
  cases read at most 5e-4 of the bound).
"""

import functools
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from state_policy_diffusionmodel_tpu.models import pallas_ops as po
from state_policy_diffusionmodel_tpu.models import unet as ju
from state_policy_diffusionmodel_torch.models import cuda_ops
from state_policy_diffusionmodel_torch.models import unet as tu
from state_policy_diffusionmodel_torch.params_from_jax import load_into

ATOL = 1e-5
DC_ATOL = 3e-5
BF16_ULP = 2 ** -7
DTYPES = ["float32", "bfloat16"]

# (B, H, W, Cin), Cout: the four U-Net levels (32x8, 16x4, 8x2 with W=2,
# 4x1 with W=1 and H*W=4) at narrow widths
CONV_CASES = [((2, 32, 8, 8), 16), ((4, 16, 4, 16), 8), ((8, 8, 2, 16), 24),
              ((16, 4, 1, 32), 16)]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _np(rng, shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _as(dtype, *arrays):
    """Each array rounded to `dtype` once: (jax arrays, torch tensors)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    js = [jnp.asarray(a, jdt) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
          for j in js]
    return js, ts


def _w9_to_oihw(w9: torch.Tensor, cin: int) -> torch.Tensor:
    return w9.reshape(3, 3, cin, -1).permute(3, 2, 0, 1).contiguous()


def _check(got, want, dtype, atol=ATOL):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_ULP * np.abs(want).max(), (
            err, np.abs(want).max())


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _conv_inputs(shape, cout, dtype):
    rng = np.random.default_rng(sum(shape) + cout)
    (jx, jw), (tx, tw) = _as(dtype, _np(rng, shape),
                             _np(rng, (9 * shape[-1], cout), 0.2))
    return jx, jw, tx, _w9_to_oihw(tw, shape[-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv3x3_ref_matches_pallas_kernel(interpret, shape, cout, dtype):
    jx, jw, tx, tw = _conv_inputs(shape, cout, dtype)
    got = cuda_ops.conv3x3_ref(tx, tw)
    assert got.dtype == tx.dtype
    _check(got, po._conv3x3_pallas(jx, jw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv3x3_ref_matches_xla9(shape, cout, dtype):
    jx, jw, tx, tw = _conv_inputs(shape, cout, dtype)
    _check(cuda_ops.conv3x3_ref(tx, tw), po._conv3x3_xla9(jx, jw), dtype)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

GN_VARIANTS = {"gn": {}, "gelu": dict(gelu=True), "post": dict(post=True),
               "post_res": dict(post=True, res=True)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 4, 16), (8, 4, 1, 32)])
@pytest.mark.parametrize("variant", list(GN_VARIANTS))
def test_gn_act_ref_matches_pallas_kernel(interpret, variant, shape, dtype):
    opts = GN_VARIANTS[variant]
    B, C = shape[0], shape[-1]
    rng = np.random.default_rng(len(variant) + C)
    (jx, jg, jb, jps, jpb, jres), (tx, tg, tb, tps, tpb, tres) = _as(
        dtype, _np(rng, shape, 2.0, 0.5), _np(rng, (C,), 0.3, 1.0),
        _np(rng, (C,), 0.2), _np(rng, (B, C), 0.2, 1.0),
        _np(rng, (B, C), 0.3), _np(rng, shape))
    post, res = opts.get("post", False), opts.get("res", False)
    gelu = opts.get("gelu", False)
    want = po._gn_act_pallas(jx, jg, jb, ps=jps if post else None,
                             pb=jpb if post else None,
                             x_res=jres if res else None, gelu=gelu)
    got = cuda_ops.gn_act_ref(tx, tg, tb, tps if post else None,
                              tpb if post else None, tres if res else None,
                              gelu)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

# the three shapes of tests/test_pallas_ops.py's
# test_double_conv_pallas_matches_xla (ps, pb at identity), and one with
# the per-(batch, channel) affine away from it
DC_CASES = [((4, 32, 8, 16), 16, 16, True, False),
            ((8, 8, 2, 32), 32, 16, False, False),
            ((16, 4, 1, 16), 32, 32, False, False),
            ((4, 16, 4, 16), 16, 16, True, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,cmid,cout,residual,affine", DC_CASES)
def test_double_conv_matches_dc_tpu(interpret, shape, cmid, cout, residual,
                                    affine, dtype):
    rng = np.random.default_rng(7)
    B, H, W, C = shape
    ps = _np(rng, (B, cout), 0.2, 1.0) if affine else np.ones((B, cout),
                                                              np.float32)
    pb = _np(rng, (B, cout), 0.3) if affine else np.zeros((B, cout),
                                                          np.float32)
    js, ts = _as(dtype, _np(rng, shape, 0.5), _np(rng, (9 * C, cmid), 0.1),
                 _np(rng, (9 * cmid, cout), 0.1), _np(rng, (cmid,), 1, 1),
                 _np(rng, (cmid,), 0.2), _np(rng, (cout,), 1, 1),
                 _np(rng, (cout,), 0.2), ps, pb)
    want = po._dc_tpu(*js, residual)
    ts[1], ts[2] = _w9_to_oihw(ts[1], C), _w9_to_oihw(ts[2], cmid)
    with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"):
        got = cuda_ops.double_conv(*ts, residual)
    assert got.dtype == ts[0].dtype
    _check(got, want, dtype, atol=DC_ATOL)


# ---------------------------------------------------------------------------
# the selector and the dispatchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ({}, "xla9"), ({"SPDM_CONV_PATH": "pallas"}, "pallas"),
    ({"SPDM_CONV_PATH": "xla"}, "xla"), ({"SPDM_PALLAS_CONV": "1"}, "pallas")])
def test_conv_path_selector_reads_env_once(env, want):
    clean = {k: v for k, v in os.environ.items()
             if k not in ("SPDM_CONV_PATH", "SPDM_PALLAS_CONV")}
    out = subprocess.run(
        [sys.executable, "-c", "from state_policy_diffusionmodel_torch."
         "models import cuda_ops; print(cuda_ops.CONV_PATH)"],
        env={**clean, **env}, capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


def test_cpu_tensors_take_plain_versions_on_pallas_path():
    """With CONV_PATH="pallas" and shapes the kernels would take on a card
    (Cin >= 8, B*H*W >= 1024), the dispatchers run the plain versions on
    CPU tensors, exactly, and count no launches."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_np(rng, (4, 32, 8, 16)))
    w = torch.from_numpy(_np(rng, (16, 16, 3, 3), 0.1))
    g, b = torch.ones(16), torch.zeros(16)
    ps, pb = torch.ones(4, 16), torch.zeros(4, 16)
    counters = (cuda_ops.conv3x3_cuda, cuda_ops.gn_act_cuda,
                cuda_ops.double_conv_cuda)
    before = [f.launches for f in counters]
    with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"):
        pairs = [
            (cuda_ops.conv3x3(x, w), cuda_ops.conv3x3_ref(x, w)),
            (cuda_ops.double_conv(x, w, w, g, b, g, b, ps, pb, True),
             cuda_ops.double_conv_ref(x, w, w, g, b, g, b, ps, pb, True))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("name", ["conv3x3_cuda", "gn_act_cuda",
                                  "double_conv_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    x = torch.zeros(4, 16, 4, 8)
    w, v, p = torch.zeros(8, 8, 3, 3), torch.zeros(8), torch.zeros(4, 8)
    args = {"conv3x3_cuda": (x, w), "gn_act_cuda": (x, v, v),
            "double_conv_cuda": (x, w, w, v, v, v, v, p, p)}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_ops, name)(*args)


# ---------------------------------------------------------------------------
# the slice: a width-8 UNetFiLM forward on the conv-kernel path
# ---------------------------------------------------------------------------

def test_unet_width8_conv_kernel_path_matches_jax(interpret, monkeypatch):
    """JAX with its conv kernels on (`_on_tpu` and `_PALLAS_CONV` patched
    true, Pallas in interpret mode; attention takes its Pallas kernel too)
    against the port with CONV_PATH="pallas". B=64: B*H*W >= 1024 at the
    32x8, 16x4 and 8x2 levels, so their DoubleConvs (Cin >= 8) go through
    `_dc_tpu`, and the 4x1 level takes `_double_conv_xla`."""
    monkeypatch.setattr(po, "_on_tpu", lambda: True)
    monkeypatch.setattr(po, "_PALLAS_CONV", True)
    rng = np.random.default_rng(14)
    B, cond_dim = 64, 40
    x = _np(rng, (B, 31, 5, 1))
    t = rng.integers(0, 1000, size=B).astype(np.int32)
    cond = _np(rng, (B, cond_dim))
    jm = ju.build_model("UNet_Film", time_dim=32, width=8)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x[:2]),
                              jnp.asarray(t[:2]), jnp.asarray(cond[:2]))
    params = jax.tree.map(lambda p: np.asarray(p, np.float32)
                          + _np(rng, p.shape, 0.05), params["params"])
    seen, dc_tpu = [], po._dc_tpu
    monkeypatch.setattr(po, "_dc_tpu", lambda *a: seen.append(
        tuple(a[0].shape[1:3])) or dc_tpu(*a))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(cond))
    tm = load_into(tu.build_model("UNet_Film", cond_dim, time_dim=32,
                                  width=8), params)
    with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"), \
            torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(cond))
    assert tuple(got.shape) == (B, 31, 5, 1)
    # the ten DoubleConvs of the three upper levels ran the Pallas kernels
    assert sorted(set(seen)) == [(8, 2), (16, 4), (32, 8)] and len(seen) == 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
