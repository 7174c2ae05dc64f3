"""The port's differentiable kernel paths against the JAX package's custom
VJPs, on CPU: K6's plain version (`conv_dw_ref`) and the autograd Functions
around K1, K3, K5 and the training conv (`Conv3x3T`).

Each Function takes its forward (for `Conv3x3T` its weight gradient) as an
argument; on a card it is the kernel, here the plain version, so these
tests run the very backward bodies the card runs. The JAX side runs as its
own tests run it: Pallas kernels in TPU interpret mode (monkeypatched
`pallas_call`), XLA elsewhere. The same inputs, from a seeded numpy
generator, go to both.

Tolerances:
- float32 gradients: 1e-5 of the largest |value| of each compared tensor.
  Both sides sum the same f32 products in another order (K = B*H*W = 512
  to 2048 pixels for dw, ~1e-6 apart), as tests/test_torch_conv_path.py
  holds the forwards at 1e-5.
- bfloat16 attention: one bf16 ulp of the largest output, max |got - want|
  <= 2**-7 * max |want|: both compute in f32 and round each result once.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from state_policy_diffusionmodel_tpu.models import pallas_ops as po
from state_policy_diffusionmodel_torch.models import cuda_ops

REL = 1e-5
BF16_ULP = 2 ** -7

# (B, H, W, Cin), Cout at the four U-Net levels, narrow widths
CONV_CASES = [((2, 32, 8, 8), 16), ((4, 16, 4, 16), 8), ((8, 8, 2, 16), 24),
              ((16, 4, 1, 32), 16)]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _np(rng, shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _w9_to_oihw(w9: np.ndarray, cin: int) -> np.ndarray:
    return np.ascontiguousarray(
        w9.reshape(3, 3, cin, -1).transpose(3, 2, 0, 1))


def _oihw_to_w9(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0)).reshape(
        -1, w.shape[0])


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _conv_case(shape, cout, seed=0):
    rng = np.random.default_rng(seed + sum(shape) + cout)
    x = _np(rng, shape)
    w9 = _np(rng, (9 * shape[-1], cout), 0.2)
    g = _np(rng, shape[:3] + (cout,))
    return x, w9, g


# ---------------------------------------------------------------------------
# K6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv_dw_ref_matches_pallas_kernel_and_autodiff(interpret, shape,
                                                        cout, dtype):
    """conv_dw_ref against `_conv_dw_pallas` (interpret mode) and against
    jax.grad of `_conv3x3_xla9` in its weights. bf16 inputs: both sides
    widen the bf16 values and sum exact products in f32."""
    x, w9, g = _conv_case(shape, cout)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32)))
    if dtype == "bfloat16":
        tx, tg = tx.bfloat16(), tg.bfloat16()
    got = cuda_ops.conv_dw_ref(tx, tg)
    assert got.dtype == torch.float32 and got.shape == (cout, shape[-1], 3, 3)
    cin = shape[-1]
    to_oihw = lambda dw9: _w9_to_oihw(np.asarray(dw9, np.float32), cin)
    _close(got, to_oihw(po._conv_dw_pallas(jx, jg)))
    if dtype == "float32":
        _, vjp = jax.vjp(lambda w: po._conv3x3_xla9(jx, w),
                         jnp.asarray(w9))
        _close(got, to_oihw(vjp(jg)[0]))


# ---------------------------------------------------------------------------
# the Functions: forward and VJP against the JAX custom VJPs
# ---------------------------------------------------------------------------

def _vjp_both(jfn, tfn, x, w9, g):
    """(port out, dx, dw OIHW), (jax out, dx, dw OIHW) of fn(x, w) with
    cotangent g."""
    cin = x.shape[-1]
    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w9))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(_w9_to_oihw(w9, cin)).requires_grad_()
    tout = tfn(tx, tw)
    tdx, tdw = torch.autograd.grad(tout, (tx, tw), torch.from_numpy(g))
    return (tout, tdx, tdw), (out, jdx,
                              _w9_to_oihw(np.asarray(jdw, np.float32), cin))


@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv3x3_t_function_matches_jax_vjp(interpret, shape, cout):
    """`Conv3x3T` with K6's plain version against `_conv3x3_t` (plain
    forward, `_conv_dw_pallas` for dw in interpret mode)."""
    x, w9, g = _conv_case(shape, cout, seed=1)
    got, want = _vjp_both(
        po._conv3x3_t,
        lambda x, w: cuda_ops.Conv3x3T.apply(cuda_ops.conv_dw_ref, x, w),
        x, w9, g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv3x3_kernel_function_matches_jax_vjp(interpret, shape, cout):
    """`Conv3x3Kernel` (K3's Function) with K3's plain version against
    `_conv3x3_p`: `_conv3x3_pallas` forward, `_conv3x3_bwd` backward."""
    x, w9, g = _conv_case(shape, cout, seed=2)
    got, want = _vjp_both(
        po._conv3x3_p,
        lambda x, w: cuda_ops.Conv3x3Kernel.apply(cuda_ops.conv3x3_ref, x,
                                                  w),
        x, w9, g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("shape,cmid,cout,residual", [
    ((4, 16, 4, 16), 16, 16, True), ((4, 16, 4, 8), 16, 24, False)])
def test_double_conv_function_matches_jax_vjp(interpret, shape, cmid, cout,
                                              residual):
    """`DoubleConvKernel` (K5's Function) with K5's plain version against
    `_dc_p`: `_dc_tpu` forward in interpret mode, `_dc_bwd` (autodiff of
    `_double_conv_xla`) backward; the gradient of every input."""
    rng = np.random.default_rng(3 + cout)
    B, H, W, C = shape
    args = [_np(rng, shape, 0.5), _np(rng, (9 * C, cmid), 0.1),
            _np(rng, (9 * cmid, cout), 0.1), _np(rng, (cmid,), 0.3, 1.0),
            _np(rng, (cmid,), 0.2), _np(rng, (cout,), 0.3, 1.0),
            _np(rng, (cout,), 0.2), _np(rng, (B, cout), 0.2, 1.0),
            _np(rng, (B, cout), 0.3)]
    g = _np(rng, (B, H, W, cout))
    out, vjp = jax.vjp(lambda *a: po._dc_p(*a, residual),
                       *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a) for a in args]
    ts[1], ts[2] = (torch.from_numpy(_w9_to_oihw(args[1], C)),
                    torch.from_numpy(_w9_to_oihw(args[2], cmid)))
    ts = [t.requires_grad_() for t in ts]
    tout = cuda_ops.DoubleConvKernel.apply(cuda_ops.double_conv_ref,
                                           residual, *ts)
    got = torch.autograd.grad(tout, ts, torch.from_numpy(g))
    _close(tout, out, 3e-5)     # the forward's bound in test_torch_conv_path
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b, np.float32)
        if i in (1, 2):
            b = _w9_to_oihw(b, C if i == 1 else cmid)
        _close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,C", [(64, 32), (16, 64), (4, 32)])
def test_attention_core_function_matches_jax_vjp(T, C, dtype):
    """The port's differentiable `attention_core` on CPU tensors (the
    `AttentionCore` Function over the plain version) against
    jax.vjp(attention_core): forward `_attn_xla`, backward `_attn_bwd`."""
    rng = np.random.default_rng(T + C)
    B, heads = 3, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, g = (jnp.asarray(_np(rng, (B, T, C)), jdt) for _ in range(4))
    out, vjp = jax.vjp(lambda q, k, v: po.attention_core(q, k, v, heads),
                       q, k, v)
    want = (out,) + vjp(g)
    to = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tq, tk, tv = (to(a).requires_grad_() for a in (q, k, v))
    tout = cuda_ops.attention_core(tq, tk, tv, heads)
    got = (tout,) + torch.autograd.grad(tout, (tq, tk, tv), to(g))
    for a, b in zip(got, want):
        assert a.dtype == tq.dtype
        _close(a, b, BF16_ULP if dtype == "bfloat16" else REL)


# ---------------------------------------------------------------------------
# the raw wrappers refuse to cut a gradient; the selector; K6's plan
# ---------------------------------------------------------------------------

def _raw_calls(requires_grad):
    x = torch.zeros(4, 16, 4, 8, requires_grad=requires_grad)
    w, v = torch.zeros(8, 8, 3, 3), torch.zeros(8)
    p, q = torch.zeros(4, 8), torch.zeros(2, 16, 32)
    return {"conv3x3_cuda": lambda: cuda_ops.conv3x3_cuda(x, w),
            "gn_act_cuda": lambda: cuda_ops.gn_act_cuda(x, v, v),
            "double_conv_cuda": lambda: cuda_ops.double_conv_cuda(
                x, w, w, v, v, v, v, p, p),
            "conv_dw_cuda": lambda: cuda_ops.conv_dw_cuda(x, x),
            "attention_core_cuda": lambda: cuda_ops.attention_core_cuda(
                q.requires_grad_(requires_grad), q, q, 4)}


@pytest.mark.parametrize("name", ["conv3x3_cuda", "gn_act_cuda",
                                  "double_conv_cuda", "conv_dw_cuda",
                                  "attention_core_cuda"])
def test_raw_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """The grad check comes before any device check, so it runs here: with
    grad mode on and an input that requires grad, every raw wrapper raises
    (its result would carry no gradient). Without either it goes on to the
    device check and refuses the CPU tensor."""
    with pytest.raises(RuntimeError, match="requires grad"):
        _raw_calls(True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _raw_calls(True)[name]()
    with pytest.raises(ValueError, match="CUDA"):
        _raw_calls(False)[name]()


@pytest.mark.parametrize("env,want", [({}, ""),
                                      ({"SPDM_CONV_BWD": "pallas"}, "pallas")])
def test_conv_bwd_selector_reads_env_once(env, want):
    clean = {k: v for k, v in os.environ.items() if k != "SPDM_CONV_BWD"}
    out = subprocess.run(
        [sys.executable, "-c", "from state_policy_diffusionmodel_torch."
         "models import cuda_ops; print(repr(cuda_ops.CONV_BWD))"],
        env={**clean, **env}, capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == repr(want)


def test_select_conv_is_plain_on_cpu_and_counts_nothing(monkeypatch):
    """Under CONV_BWD="pallas", CPU tensors at a shape K6 would take on a
    card get the plain conv, whose gradient equals autograd's, and no K6
    launch is counted."""
    monkeypatch.setattr(cuda_ops, "CONV_BWD", "pallas")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_np(rng, (4, 32, 8, 16))).requires_grad_()
    w = torch.from_numpy(_np(rng, (16, 16, 3, 3), 0.1)).requires_grad_()
    before = cuda_ops.conv_dw_cuda.launches
    assert not cuda_ops.takes_dw_kernel(x, 16, 16)
    out = cuda_ops.select_conv(x, w)
    g = torch.from_numpy(_np(rng, tuple(out.shape)))
    got = torch.autograd.grad(out, (x, w), g)
    want = torch.autograd.grad(cuda_ops.conv3x3_ref(x, w), (x, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_ops.conv_dw_cuda.launches == before


# (H, W, Cin, Cout) of the 31 convs of one r5blend training step that K6
# takes on SPDM_CONV_BWD=pallas (B=256)
TRAIN_CONVS = [(32, 8, 64, 64)] + [
    c for H, W, cin, cout in [
        (16, 4, 64, 64), (16, 4, 64, 128), (8, 2, 128, 128),
        (8, 2, 128, 256), (4, 1, 256, 256), (4, 1, 256, 256),
        (4, 1, 256, 512), (4, 1, 512, 512), (4, 1, 512, 256),
        (8, 2, 512, 512), (8, 2, 512, 128), (16, 4, 256, 256),
        (16, 4, 256, 64), (32, 8, 128, 128), (32, 8, 128, 64)]
    for c in ((H, W, cin, cout), (H, W, cout, cout))]


@pytest.mark.parametrize("H,W,cin,cout", sorted(set(TRAIN_CONVS)))
def test_conv_dw_plan_covers_the_pixels_and_fills_the_card(H, W, cin, cout):
    """K6's pixel chunks in fp32 (the training path's type): whole K steps,
    at least four of them, every pixel in exactly one chunk, none empty,
    and about two blocks per SM of an H100 (132 SMs) where the pixels allow
    it (rounding chunks to whole steps may leave a few blocks fewer); the
    workspace holds every chunk's partial sums."""
    pixels = 256 * H * W
    plan = cuda_ops.conv_dw_plan(256, H, W, cin, cout, torch.float32, 132)
    chunks, per, step = plan.chunks, plan.chunk_pixels, plan.step
    assert per % step == 0 and per >= 4 * step
    assert (chunks - 1) * per < pixels <= chunks * per
    tiles = -(-cin // 32) * -(-cout // 64)
    assert plan.tiles == tiles
    assert chunks * tiles >= 1.8 * 132 or chunks == -(-pixels // step) // 4
    assert plan.ws_elems == chunks * cout * 9 * cin
    assert len(TRAIN_CONVS) == 31
