"""Parity of the PyTorch port's ops and layers with the JAX package, on CPU.

The same inputs, made from a seeded numpy generator, go through the flax /
jax function and its port; flax parameters go to the torch modules through
the weight bridge (`params_from_jax.load_into`). Everything runs in float32
(tests/conftest.py pins jax matmuls to float32); the port runs its plain
PyTorch path, which is what CPU tensors take. Tolerance 1e-5 absolute
unless a case states otherwise.
"""

import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from state_policy_diffusionmodel_tpu.models import autoencoder as jae
from state_policy_diffusionmodel_tpu.models import layers as jl
from state_policy_diffusionmodel_tpu.models import pallas_ops as po
from state_policy_diffusionmodel_tpu.models import unet as ju
from state_policy_diffusionmodel_torch.models import autoencoder as tae
from state_policy_diffusionmodel_torch.models import cuda_ops
from state_policy_diffusionmodel_torch.models import layers as tl
from state_policy_diffusionmodel_torch.models import unet as tu
from state_policy_diffusionmodel_torch.params_from_jax import load_into

ATOL = 1e-5

# (T, C) of the five attention calls of one r5blend U-Net forward (4 heads)
R5BLEND_ATTN = [(64, 128), (16, 256), (16, 128), (64, 64), (256, 64)]
# the shapes the card's kernel takes beyond r5blend's: those of a forward
# at --model_width 128 (its (16, 256) and (64, 128) are r5blend's too), and
# T=384 (a 48x8 input, --pred_horizon 40) at widths 64 and 128
WIDE_ATTN = [(64, 256), (16, 512), (256, 128), (384, 64), (384, 128)]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _flax_params(module, rng, *args, perturb=0.1, static=()):
    """flax init, then every leaf moved off its init value (biases and
    norms start at 0/1, which would hide a layout error). `static` are
    trailing non-array arguments."""
    init = jax.jit(lambda key, *a: module.init(key, *a, *static))
    params = init(jax.random.key(0), *args)["params"]
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + _np(rng, p.shape, perturb), params)


# ---------------------------------------------------------------------------
# attention core (K1's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,C", R5BLEND_ATTN + WIDE_ATTN)
def test_attention_core_ref_matches_attn_xla(T, C):
    rng = np.random.default_rng(T * 1000 + C)
    q, k, v = (_np(rng, (3, T, C)) for _ in range(3))
    want = po._attn_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    _close(cuda_ops.attention_core_ref(_t(q), _t(k), _t(v), 4), want)


# heads wider than 128, which the card's kernel takes on its row path: Dh
# = 160 (ragged and whole T) and 256 (the width-256 UNetFiLM's (16, 1024))
WIDE_HEADS = [(16, 640), (20, 640), (16, 1024), (64, 1024)]


@pytest.mark.parametrize("T,C", WIDE_HEADS)
def test_attention_core_ref_wide_heads_match_attn_xla(T, C):
    """fp32, within 1e-5 of the largest output."""
    rng = np.random.default_rng(T + C)
    q, k, v = (_np(rng, (2, T, C)) for _ in range(3))
    want = np.asarray(po._attn_xla(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 4))
    got = cuda_ops.attention_core_ref(_t(q), _t(k), _t(v), 4).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("T,C", R5BLEND_ATTN + WIDE_ATTN)
def test_attention_core_ref_matches_pallas_kernel(interpret, T, C):
    rng = np.random.default_rng(T * 7 + C)
    B = 1 if (T, C) in WIDE_ATTN else 2       # keeps interpret mode quick
    q, k, v = (_np(rng, (B, T, C)) for _ in range(3))
    want = po._attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    _close(cuda_ops.attention_core_ref(_t(q), _t(k), _t(v), 4), want)


@pytest.mark.parametrize("T,C", [(64, 128), (16, 256)] + WIDE_ATTN)
def test_attention_core_ref_bf16_matches_attn_xla(T, C):
    """bf16 in and out: both round q/sqrt(Dh), p and the output to bf16;
    tolerance is one bf16 ulp at |x| < 4 (2**-6)."""
    rng = np.random.default_rng(5)
    q, k, v = (_np(rng, (2, T, C)) for _ in range(3))
    want = po._attn_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 4)
    got = cuda_ops.attention_core_ref(
        *(_t(a).to(torch.bfloat16) for a in (q, k, v)), 4)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2 ** -6)


def test_attention_core_dispatch_on_cpu_takes_plain_version():
    rng = np.random.default_rng(1)
    q, k, v = (_t(_np(rng, (2, 64, 128))) for _ in range(3))
    before = cuda_ops.attention_core.launches
    out = cuda_ops.attention_core(q, k, v, 4)
    assert cuda_ops.attention_core.launches == before
    torch.testing.assert_close(out, cuda_ops.attention_core_ref(q, k, v, 4),
                               rtol=0, atol=0)


def test_attention_core_cuda_refuses_cpu_tensors():
    q = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ops.attention_core_cuda(q, q, q, 4)


def test_attention_core_head_limit_mirrors_the_kernel():
    """The wrapper's limits are the CUDA launcher's: heads up to kMaxDh
    (128) take the tiles, wider ones the row kernel, whose kRowWarps rows
    of Dh + T floats must fit kMaxSmem bytes of shared memory; the card
    test checks the raise past that."""
    csrc = Path(cuda_ops.__file__).parents[1] / "csrc"
    src = (csrc / "attention_core.cu").read_text()

    def const(name, text):
        expr = re.search(rf"constexpr int {name} = ([\d *]+);", text)
        return math.prod(int(t) for t in expr.group(1).split("*"))

    assert const("kMaxDh", src) == cuda_ops.ATTN_TILE_MAX_DH == 128
    smem = const("kMaxSmem", (csrc / "conv_tile.cuh").read_text())
    assert smem == 227 * 1024
    assert smem // (const("kRowWarps", src) * 4) == cuda_ops.ATTN_ROWS_MAX


# ---------------------------------------------------------------------------
# conv path (plain formulations of K3/K4/K5)
# ---------------------------------------------------------------------------

def _w9_to_oihw(w9, cin):
    return np.ascontiguousarray(
        w9.reshape(3, 3, cin, -1).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("shape,cout", [
    ((2, 32, 8, 8), 16), ((2, 8, 2, 32), 16), ((3, 4, 1, 16), 8),
    ((2, 32, 8, 1), 8)])
def test_conv3x3_matches_xla9(shape, cout):
    rng = np.random.default_rng(shape[1] + cout)
    x = _np(rng, shape)
    w9 = _np(rng, (9 * shape[-1], cout), 0.2)
    want = po._conv3x3_xla9(jnp.asarray(x), jnp.asarray(w9))
    _close(cuda_ops.conv3x3(_t(x), _t(_w9_to_oihw(w9, shape[-1]))), want)


def test_gn_f32_matches():
    rng = np.random.default_rng(2)
    h = _np(rng, (3, 32, 16), 2.0) + 0.5
    g, b = _np(rng, (16,)), _np(rng, (16,))
    want = po._gn_f32(jnp.asarray(h), jnp.asarray(g), jnp.asarray(b))
    _close(cuda_ops.gn_f32(_t(h), _t(g), _t(b)), want)


@pytest.mark.parametrize("residual", [False, True])
def test_double_conv_matches_xla(residual):
    rng = np.random.default_rng(3 + residual)
    B, H, W, C, M = 2, 16, 4, 8, 8
    x = _np(rng, (B, H, W, C))
    w1, w2 = _np(rng, (9 * C, M), 0.2), _np(rng, (9 * M, M), 0.2)
    g1, b1, g2, b2 = (_np(rng, (M,)) for _ in range(4))
    ps, pb = _np(rng, (B, M)), _np(rng, (B, M))
    want = po._double_conv_xla(*(jnp.asarray(a) for a in (
        x, w1, w2, g1, b1, g2, b2, ps, pb)), residual)
    got = cuda_ops.double_conv(
        _t(x), _t(_w9_to_oihw(w1, C)), _t(_w9_to_oihw(w2, M)),
        *(_t(a) for a in (g1, b1, g2, b2, ps, pb)), residual)
    _close(got, want)


def test_gelu_and_mish_match():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(cuda_ops.gelu_exact(_t(x)), po._gelu_exact(jnp.asarray(x)))
    import flax.linen as nn
    _close(tl.gelu(_t(x)), nn.gelu(jnp.asarray(x), approximate=False))
    _close(tl.mish(_t(x)), jax.nn.mish(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

def test_sinusoidal_time_embedding_matches():
    t = np.array([0, 1, 99, 500, 999], np.int32)
    for dim in (32, 256):
        want = jl.sinusoidal_time_embedding(jnp.asarray(t), dim)
        _close(tl.sinusoidal_time_embedding(torch.from_numpy(t), dim), want)


def test_pad_to_unpad_horizon_31x5():
    """31 x 5 pads to 32 x 8: (0, 1) rows and (1, 2) columns."""
    rng = np.random.default_rng(4)
    x = _np(rng, (2, 31, 5, 1))
    want, wpads = jl.pad_to(jnp.asarray(x), 8)
    got, pads = tl.pad_to(_t(x), 8)
    assert tuple(got.shape) == (2, 32, 8, 1)
    assert pads == wpads == (1, 2, 0, 1)
    _close(got, want)
    _close(tl.unpad(got, pads), jl.unpad(want, wpads))


@pytest.mark.parametrize("shape", [(2, 4, 1, 3), (2, 8, 2, 3),
                                   (2, 16, 4, 2)])
def test_upsample_align_corners_matches(shape):
    rng = np.random.default_rng(shape[1])
    x = _np(rng, shape)
    _close(tl.upsample_align_corners(_t(x)),
           jl.upsample_align_corners(jnp.asarray(x)))


def test_max_pool_2x2_matches():
    rng = np.random.default_rng(6)
    x = _np(rng, (2, 8, 4, 3))
    _close(tl.max_pool_2x2(_t(x)), jl.max_pool_2x2(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# modules, width 8, random params carried over by the bridge
# ---------------------------------------------------------------------------

def _module_case(jmod, tmod, args, kwargs_t=None, seed=0):
    rng = np.random.default_rng(seed)
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    params = _flax_params(jmod, rng, *jargs)
    want = jmod.apply({"params": params}, *jargs)
    load_into(tmod, params)
    with torch.no_grad():
        got = tmod(*[_t(a) if a is not None else None for a in args])
    return got, want


def test_conv3x3_module_matches():
    rng = np.random.default_rng(7)
    x = _np(rng, (2, 8, 4, 6))
    got, want = _module_case(jl.Conv3x3(5), tl.Conv3x3(6, 5), [x])
    _close(got, want)


@pytest.mark.parametrize("cin,out,mid,residual", [
    (8, 8, None, False), (8, 8, None, True), (4, 8, None, False),
    (8, 12, 6, False)])
def test_double_conv_module_matches(cin, out, mid, residual):
    rng = np.random.default_rng(cin + out)
    x = _np(rng, (2, 8, 4, cin))
    ps, pb = _np(rng, (2, out)), _np(rng, (2, out))
    jm = jl.DoubleConv(out, residual=residual, mid_channels=mid)
    tm = tl.DoubleConv(cin, out, residual=residual, mid_channels=mid)
    got, want = _module_case(jm, tm, [x, ps, pb])
    _close(got, want)


@pytest.mark.parametrize("hw,c", [((16, 4), 16), ((4, 1), 32),
                                  ((32, 8), 8)])
def test_self_attention_matches(hw, c):
    rng = np.random.default_rng(c)
    x = _np(rng, (2, *hw, c))
    got, want = _module_case(jl.SelfAttention(c), tl.SelfAttention(c), [x])
    _close(got, want)


@pytest.mark.parametrize("with_cond", [True, False])
def test_post_affine_matches(with_cond):
    rng = np.random.default_rng(11)
    t_emb = _np(rng, (3, 32))
    cond = _np(rng, (3, 20)) if with_cond else None
    jm = jl._PostAffine(8)
    params = _flax_params(jm, rng, jnp.asarray(t_emb),
                          None if cond is None else jnp.asarray(cond),
                          static=(jnp.float32,))
    want = jm.apply({"params": params}, jnp.asarray(t_emb),
                    None if cond is None else jnp.asarray(cond), jnp.float32)
    tm = load_into(tl._PostAffine(8, 32, 20 if with_cond else None), params)
    with torch.no_grad():
        got = tm(_t(t_emb), None if cond is None else _t(cond))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_down_block_matches():
    rng = np.random.default_rng(12)
    x, t_emb, cond = _np(rng, (2, 16, 4, 8)), _np(rng, (2, 32)), \
        _np(rng, (2, 20))
    got, want = _module_case(jl.DownBlock(16), tl.DownBlock(8, 16, 32, 20),
                             [x, t_emb, cond])
    _close(got, want)


def test_up_block_matches():
    rng = np.random.default_rng(13)
    x, skip = _np(rng, (2, 8, 2, 16)), _np(rng, (2, 16, 4, 8))
    t_emb, cond = _np(rng, (2, 32)), _np(rng, (2, 20))
    got, want = _module_case(jl.UpBlock(8), tl.UpBlock(24, 8, 32, 20),
                             [x, skip, t_emb, cond])
    _close(got, want)


@pytest.mark.parametrize("name", ["UNet_Film", "UNet_FilmnoAttention"])
def test_unet_film_width8_matches(name):
    rng = np.random.default_rng(14)
    B, cond_dim = 3, 40
    x = _np(rng, (B, 31, 5, 1))
    t = np.array([999, 500, 3], np.int32)
    cond = _np(rng, (B, cond_dim))
    jm = ju.build_model(name, time_dim=32, width=8)
    params = _flax_params(jm, rng, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(cond), perturb=0.05)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                             jnp.asarray(t), jnp.asarray(cond))
    tm = load_into(tu.build_model(name, cond_dim, time_dim=32, width=8),
                   params)
    with torch.no_grad():
        got = tm(_t(x), torch.from_numpy(t), _t(cond))
    assert tuple(got.shape) == (B, 31, 5, 1)
    _close(got, want)


def test_encoder_matches():
    rng = np.random.default_rng(15)
    x = rng.uniform(size=(2, 96, 96, 3)).astype(np.float32)
    got, want = _module_case(jae.Encoder(16), tae.Encoder(16), [x])
    assert tuple(got.shape) == (2, 16)
    _close(got, want)
