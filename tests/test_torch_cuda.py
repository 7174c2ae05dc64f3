"""The PyTorch port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip without one: a CUDA kernel has no
CPU mode. They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from state_policy_diffusionmodel_torch.models import cuda_ops

pytestmark = pytest.mark.cuda

# (T, C) of the five attention calls of one r5blend U-Net forward, and two
# shapes off that grid (T not a power of two; Dh = 8)
SHAPES = [(64, 128), (16, 256), (16, 128), (64, 64), (256, 64), (20, 96),
          (200, 32)]
# fp32: summation order and expf only; bf16: one ulp of p or the output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


@pytest.fixture()
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # the plain versions in full fp32: cuDNN convolves in TF32 by default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C", SHAPES)
def test_attention_kernel_matches_plain(device, T, C, dtype):
    gen = torch.Generator(device=device).manual_seed(T * 1000 + C)
    q, k, v = (torch.randn((3, T, C), generator=gen, device=device).to(dtype)
               for _ in range(3))
    before = cuda_ops.attention_core.launches
    got = cuda_ops.attention_core(q, k, v, 4)
    torch.cuda.synchronize()
    assert cuda_ops.attention_core.launches == before + 1
    want = cuda_ops.attention_core_ref(q, k, v, 4)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


def test_attention_small_shapes_take_plain_version(device):
    q = torch.randn((2, 4, 256), device=device)       # the 4x1 bottleneck
    before = cuda_ops.attention_core.launches
    out = cuda_ops.attention_core(q, q, q, 4)
    assert cuda_ops.attention_core.launches == before
    torch.testing.assert_close(out, cuda_ops.attention_core_ref(q, q, q, 4))


def test_attention_kernel_refuses_what_it_does_not_take(device):
    q = torch.randn((2, 64, 128), device=device)
    with pytest.raises(TypeError):
        cuda_ops.attention_core_cuda(q.half(), q.half(), q.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        cuda_ops.attention_core_cuda(t, t, t, 4)
    big = torch.randn((1, 300, 64), device=device)
    with pytest.raises(ValueError, match="limits"):
        cuda_ops.attention_core_cuda(big, big, big, 4)


# ---------------------------------------------------------------------------
# K2: sample_banked
# ---------------------------------------------------------------------------

def _k2_inputs(device, B=64, seed=0):
    """A 4-track bank and B poses: half near the first track's centerline,
    the rest anywhere on the playfield, on its edges and off it."""
    from state_policy_diffusionmodel_torch.render import raster
    from state_policy_diffusionmodel_torch.track import PLAYFIELD, \
        load_or_build_bank

    bank = load_or_build_bank(4, bake=True, device=device)
    gen = torch.Generator().manual_seed(seed)
    ang = torch.rand(B, generator=gen) * 6.3 - 3.15
    pos = (torch.rand((B, 2), generator=gen) * 2 - 1) * PLAYFIELD * 1.1
    road = bank.seg_b[0, :200].cpu()
    pos[:B // 2] = road[torch.randint(0, 200, (B // 2,), generator=gen)]
    pos[-4:] = torch.tensor([[PLAYFIELD, 0.0], [0.0, -PLAYFIELD],
                             [PLAYFIELD + 40, 3.0], [-900.0, 900.0]])
    _, _, rx, ry = raster.pixel_planes(device)
    ids = (torch.arange(B) % 4).to(torch.int32)
    return (bank.tex, ids.to(device), torch.cos(ang).to(device),
            torch.sin(ang).to(device), pos.to(device), rx, ry)


def test_sample_banked_kernel_equals_plain(device):
    """The kernel and the plain version compute the same float32 texel map
    (no FMA contraction): every output must be equal."""
    from state_policy_diffusionmodel_torch.render import cuda_sampler as ks

    args = _k2_inputs(device)
    before = ks.sample_banked.launches
    got = ks.sample_banked(*args)
    torch.cuda.synchronize()
    assert ks.sample_banked.launches == before + 1
    want = ks.sample_banked_ref(*args)
    assert got.dtype == torch.int32 and got.shape == (64, 72, 128)
    assert int((got != want).sum()) == 0
    assert (want >= 8).any() and (want[-2:] == 0).all()


def test_sample_banked_kernel_refuses_what_it_does_not_take(device):
    from state_policy_diffusionmodel_torch.render import cuda_sampler as ks

    tex, ids, c, s, pos, rx, ry = _k2_inputs(device, B=8)
    with pytest.raises(TypeError):
        ks.sample_banked_cuda(tex, ids.long(), c, s, pos, rx, ry)
    with pytest.raises(ValueError, match="shapes"):
        ks.sample_banked_cuda(tex, ids, c[:4], s, pos, rx, ry)
    with pytest.raises(ValueError, match="contiguous"):
        ks.sample_banked_cuda(tex, ids, c, s, pos.t().contiguous().t(),
                              rx, ry)
    with pytest.raises(ValueError, match="CUDA device"):
        ks.sample_banked_cuda(tex, ids, c.cpu(), s, pos, rx, ry)


def test_env_step_renders_through_k2_once(device):
    """One rendered step of a batch is one K2 launch; frames on the card
    match the CPU's within the golden-frame budget."""
    from state_policy_diffusionmodel_torch.envs import vector
    from state_policy_diffusionmodel_torch.render import cuda_sampler as ks
    from state_policy_diffusionmodel_torch.track import load_or_build_bank

    out = {}
    for dev in (device, torch.device("cpu")):
        bank = load_or_build_bank(4, bake=True, device=dev)
        ids = (torch.arange(8) % 4).to(torch.int32).to(dev)
        st, res = vector.reset_batch(bank, track_ids=ids, device=dev)
        before = ks.sample_banked.launches
        a = torch.tensor([[0.1, 0.8, 0.0]] * 8).to(dev)
        for _ in range(5):
            st, res = vector.step_batch(st, bank, a, track_ids=ids,
                                        device=dev)
        if dev.type == "cuda":
            assert ks.sample_banked.launches == before + 5
        out[dev.type] = res.obs.cpu()
    assert int((out["cuda"] != out["cpu"]).sum(dim=(1, 2, 3)).max()) <= 30


# ---------------------------------------------------------------------------
# K3-K5: the conv path (conv3x3, gn_act, double_conv)
# ---------------------------------------------------------------------------

# max abs error over the largest output: fp32 two summation orders of
# K = 9*Cin <= 4608 products (~4e-6 of an output), bf16 one ulp (2**-7 at
# the top binade); double_conv rounds twice in series, two ulps
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
DC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _randn(gen, *shape, dtype=torch.float32, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            + shift).to(dtype)


# (B, H, W, Cin, Cout): the 4x1 level at B*H*W = 1024 with K = 4608, the 8x2
# level (W=2), the 32x8 level, and ragged ones: Cin not a multiple of 4 or
# of 16 (bf16 then takes the CUDA-core kernel, not the tensor cores), Cout
# not a multiple of 64, B*H*W not a multiple of any row tile
CONV_EDGES = [(256, 4, 1, 512, 512), (256, 4, 1, 256, 512),
              (64, 8, 2, 128, 256), (16, 32, 8, 64, 64), (3, 8, 2, 32, 24),
              (3, 32, 8, 10, 24), (7, 4, 1, 36, 40), (5, 8, 2, 8, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cout", CONV_EDGES)
def test_conv3x3_kernel_matches_plain(device, B, H, W, cin, cout, dtype):
    gen = torch.Generator(device=device).manual_seed(B * H * W + cin + cout)
    x = _randn(gen, B, H, W, cin, dtype=dtype)
    w = _randn(gen, cout, cin, 3, 3, dtype=dtype, scale=(2 / (9 * cin)) ** .5)
    before = cuda_ops.conv3x3_cuda.launches
    got = cuda_ops.conv3x3_cuda(x, w)
    torch.cuda.synchronize()
    assert cuda_ops.conv3x3_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, W, cout)
    assert _rel(got, cuda_ops.conv3x3_ref(x, w)) <= CONV_TOL[dtype]


# (B, H, W, Cin, Cout) for the plans' paths: split-K at the 8x2 and 4x1
# levels (and one without), W = 1 (three taps; Cin 48 = a 32- and a
# 16-channel slice) and W = 2, Cout off the channel tile, B*H*W off the
# pixel tile, bf16 outside the tensor-core rule (Cin % 16, Cout % 8), fp32
# with Cin or Cout off the 16-byte vectors, W = 3 and W = 16
CONV_PLAN_EDGES = [(256, 8, 2, 128, 128), (256, 4, 1, 512, 256),
                   (256, 8, 2, 512, 512), (37, 4, 1, 48, 40),
                   (9, 8, 2, 32, 24), (5, 7, 3, 20, 12), (6, 5, 5, 16, 6),
                   (3, 32, 8, 7, 130), (2, 16, 16, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cout", CONV_PLAN_EDGES)
def test_conv3x3_kernel_plan_paths_match_plain_and_repeat(device, B, H, W,
                                                          cin, cout, dtype):
    gen = torch.Generator(device=device).manual_seed(B * W + cin * cout)
    x = _randn(gen, B, H, W, cin, dtype=dtype)
    w = _randn(gen, cout, cin, 3, 3, dtype=dtype, scale=(2 / (9 * cin)) ** .5)
    plan = cuda_ops.conv3x3_plan(B, H, W, cin, cout, dtype,
                                 cuda_ops._n_sm(device))
    assert plan.mma == (dtype == torch.bfloat16 and cin % 16 == 0
                        and cout % 8 == 0)
    assert plan.taps == (3 if W == 1 else 9)
    # the split-K shapes: both types at 8x2 128->128 and 4x1 512->256, the
    # 256 x 128 tensor-core tile at 8x2 512->512
    if B == 256 and (cin, dtype) != (512, torch.float32) or W == 1 and B == 256:
        assert plan.splits > 1
    got = cuda_ops.conv3x3_cuda(x, w)
    again = cuda_ops.conv3x3_cuda(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, cout)
    assert torch.equal(got, again)            # split-K adds in order
    assert _rel(got, cuda_ops.conv3x3_ref(x, w)) <= CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 4, 1, 512), (8, 32, 8, 128),
                                   (3, 5, 3, 6)])
@pytest.mark.parametrize("variant", ["gn", "gelu", "post", "post_res"])
def test_gn_act_kernel_matches_plain(device, variant, shape, dtype):
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    B, C = shape[0], shape[-1]
    x = _randn(gen, *shape, dtype=dtype, scale=2.0, shift=0.5)
    g = _randn(gen, C, dtype=dtype, scale=0.3, shift=1.0)
    b = _randn(gen, C, dtype=dtype, scale=0.2)
    # ps as the U-Net gives it: a strided view (one row of a (B, 2, C) FiLM)
    ps = _randn(gen, B, 2, C, dtype=dtype, scale=0.2, shift=1.0)[:, 0]
    pb = _randn(gen, B, C, dtype=dtype, scale=0.3)
    xr = _randn(gen, *shape, dtype=dtype)
    args = {"gn": (x, g, b), "gelu": (x, g, b, None, None, None, True),
            "post": (x, g, b, ps, pb),
            "post_res": (x, g, b, ps, pb, xr)}[variant]
    before = cuda_ops.gn_act_cuda.launches
    got = cuda_ops.gn_act_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_ops.gn_act_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, cuda_ops.gn_act_ref(*args)) <= CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cout,residual", [
    (256, 4, 1, 256, 512, False), (64, 8, 2, 128, 128, True),
    (16, 16, 4, 64, 64, True), (4, 32, 8, 16, 24, False)])
def test_double_conv_kernel_matches_plain(device, B, H, W, cin, cout,
                                          residual, dtype):
    from unittest import mock

    gen = torch.Generator(device=device).manual_seed(B + cin + cout)
    x = _randn(gen, B, H, W, cin, dtype=dtype)
    w1 = _randn(gen, cout, cin, 3, 3, dtype=dtype, scale=(2 / (9 * cin)) ** .5)
    w2 = _randn(gen, cout, cout, 3, 3, dtype=dtype,
                scale=(2 / (9 * cout)) ** .5)
    g = _randn(gen, cout, dtype=dtype, scale=0.3, shift=1.0)
    b = _randn(gen, cout, dtype=dtype, scale=0.2)
    ps = _randn(gen, B, cout, dtype=dtype, scale=0.2, shift=1.0)
    pb = _randn(gen, B, cout, dtype=dtype, scale=0.3)
    args = (x, w1, w2, g, b, g, b, ps, pb, residual and cin == cout)
    before = (cuda_ops.conv3x3_cuda.launches, cuda_ops.gn_act_cuda.launches,
              cuda_ops.double_conv_cuda.launches)
    with mock.patch.object(cuda_ops, "CONV_PATH", "pallas"):
        got = cuda_ops.double_conv(*args)
    torch.cuda.synchronize()
    assert (cuda_ops.conv3x3_cuda.launches, cuda_ops.gn_act_cuda.launches,
            cuda_ops.double_conv_cuda.launches) == tuple(n + d for n, d in zip(
                before, (2, 2, 1)))
    assert got.dtype == dtype and got.shape == (B, H, W, cout)
    assert _rel(got, cuda_ops.double_conv_ref(*args)) <= DC_TOL[dtype]


def test_conv_path_shape_rule_sends_small_shapes_to_plain(device):
    """On the pallas path Cin < 8 or B*H*W < 1024 take the plain versions,
    as the TPU dispatch does; on the default path nothing takes a kernel."""
    from unittest import mock

    gen = torch.Generator(device=device).manual_seed(0)
    v = lambda c: torch.ones(c, device=device)
    p = lambda b, c: torch.ones((b, c), device=device)
    cases = [
        ("pallas", _randn(gen, 4, 32, 8, 4), 8),      # Cin < 8
        ("pallas", _randn(gen, 3, 32, 8, 16), 16),    # B*H*W = 768
        ("xla9", _randn(gen, 8, 32, 8, 16), 16),      # the default path
        ("xla", _randn(gen, 8, 32, 8, 16), 16)]
    for path, x, cout in cases:
        B, cin = x.shape[0], x.shape[3]
        w1 = _randn(gen, cout, cin, 3, 3, scale=0.1)
        w2 = _randn(gen, cout, cout, 3, 3, scale=0.1)
        before = (cuda_ops.conv3x3_cuda.launches, cuda_ops.gn_act_cuda.launches,
                  cuda_ops.double_conv_cuda.launches)
        with mock.patch.object(cuda_ops, "CONV_PATH", path):
            out = cuda_ops.double_conv(x, w1, w2, v(cout), v(cout) * 0,
                                       v(cout), v(cout) * 0, p(B, cout),
                                       p(B, cout) * 0)
            conv = cuda_ops.conv3x3(x, w1)
        assert (cuda_ops.conv3x3_cuda.launches, cuda_ops.gn_act_cuda.launches,
                cuda_ops.double_conv_cuda.launches) == before
        torch.testing.assert_close(out, cuda_ops.double_conv_ref(
            x, w1, w2, v(cout), v(cout) * 0, v(cout), v(cout) * 0,
            p(B, cout), p(B, cout) * 0), rtol=0, atol=0)
        torch.testing.assert_close(conv, cuda_ops.conv3x3_ref(x, w1),
                                   rtol=0, atol=0)


def test_conv_kernels_refuse_what_they_do_not_take(device):
    x = torch.randn((4, 16, 4, 8), device=device)
    w = torch.randn((8, 8, 3, 3), device=device)
    v, p = torch.ones(8, device=device), torch.ones((4, 8), device=device)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_ops.conv3x3_cuda(x.cpu(), w)
    with pytest.raises(TypeError):
        cuda_ops.conv3x3_cuda(x.half(), w.half())
    with pytest.raises(TypeError):
        cuda_ops.conv3x3_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.conv3x3_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                              w)
    with pytest.raises(ValueError, match="match"):
        cuda_ops.conv3x3_cuda(x, w[:, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_ops.gn_act_cuda(x, v.cpu(), v)
    with pytest.raises(TypeError):
        cuda_ops.gn_act_cuda(x.double(), v.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.gn_act_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                             v, v)
    with pytest.raises(ValueError, match="shapes"):
        cuda_ops.gn_act_cuda(x, v[:4], v)
    with pytest.raises(ValueError, match="shapes"):
        cuda_ops.gn_act_cuda(x, v, v, p.t().contiguous().t()[:, :8], p)
    with pytest.raises(ValueError, match="together"):
        cuda_ops.gn_act_cuda(x, v, v, p, None)
    with pytest.raises(TypeError):
        cuda_ops.double_conv_cuda(x, w, w.double(), v, v, v, v, p, p)


# ---------------------------------------------------------------------------
# K6 and the training path's autograd Functions
# ---------------------------------------------------------------------------

# (H, W, Cin, Cout) of the convs of one r5blend training step that K6 takes
# on SPDM_CONV_BWD=pallas (B=256), distinct, and two ragged shapes (Cin,
# Cout off the 32 x 64 channel tiles; B*H*W off the 16-pixel step)
DW_SHAPES = [(32, 8, 64, 64), (16, 4, 64, 64), (16, 4, 64, 128),
             (16, 4, 128, 128), (8, 2, 128, 128), (8, 2, 128, 256),
             (8, 2, 256, 256), (4, 1, 256, 256), (4, 1, 256, 512),
             (4, 1, 512, 512), (4, 1, 512, 256), (8, 2, 512, 512),
             (8, 2, 512, 128), (16, 4, 256, 256), (16, 4, 256, 64),
             (32, 8, 128, 128), (32, 8, 128, 64)]
# fp32: summation order over up to 65,536 pixels; bf16 inputs: the same
# exact products, summed in f32 by the tensor cores over chunks of at most
# 4,096 pixels, so the same bound
DW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,cin,cout", DW_SHAPES + [(5, 3, 20, 24),
                                                      (4, 1, 33, 70)])
def test_conv_dw_kernel_matches_plain_and_repeats(device, H, W, cin, cout,
                                                  dtype):
    gen = torch.Generator(device=device).manual_seed(H * W + cin + cout)
    B = 256 if cin % 32 == 0 else 7
    x = _randn(gen, B, H, W, cin).to(dtype)
    g = _randn(gen, B, H, W, cout).to(dtype)
    before = cuda_ops.conv_dw_cuda.launches
    got = cuda_ops.conv_dw_cuda(x, g)
    again = cuda_ops.conv_dw_cuda(x, g)
    torch.cuda.synchronize()
    assert cuda_ops.conv_dw_cuda.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (cout, cin, 3, 3)
    assert torch.equal(got, again)            # no atomics: bit for bit
    assert _rel(got, cuda_ops.conv_dw_ref(x, g)) <= DW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cout", CONV_PLAN_EDGES[3:])
def test_conv_dw_kernel_plan_paths_match_plain_and_repeat(device, B, H, W,
                                                          cin, cout, dtype):
    """K6 off r5blend's shapes: W = 1 on the tensor cores (three taps, the
    rest exactly zero), W = 2, 3 and 16, channels off the tiles and off the
    16-byte vectors, bf16 outside the tensor-core rule."""
    gen = torch.Generator(device=device).manual_seed(B * W + cin * cout)
    x = _randn(gen, B, H, W, cin).to(dtype)
    g = _randn(gen, B, H, W, cout).to(dtype)
    plan = cuda_ops.conv_dw_plan(B, H, W, cin, cout, dtype,
                                 cuda_ops._n_sm(device))
    assert plan.mma == (dtype == torch.bfloat16 and cin % 8 == 0
                        and cout % 8 == 0)
    got = cuda_ops.conv_dw_cuda(x, g)
    again = cuda_ops.conv_dw_cuda(x, g)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (cout, cin, 3, 3)
    assert torch.equal(got, again)
    want = cuda_ops.conv_dw_ref(x, g)
    if W == 1:
        assert not got[:, :, :, [0, 2]].any()
    assert _rel(got, want) <= DW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_launchers_take_the_ring_that_fits(device, dtype):
    """K3's and K6's launchers choose their shared-memory ring: four stages
    at every r5blend shape, fewer for a wide image (which still matches the
    plain version), and a raised refusal where no ring fits."""
    for H, W, cin, cout in DW_SHAPES:
        p3 = cuda_ops.conv3x3_plan(256, H, W, cin, cout, dtype)
        p6 = cuda_ops.conv_dw_plan(256, H, W, cin, cout, dtype)
        assert cuda_ops.conv3x3_ring(p3, W) == 4
        assert cuda_ops.conv_dw_ring(p6, H, W) == 4
    # wide enough for a shorter ring: 512 pixels a row in bf16 (the tensor
    # cores' patch rows are 24 elements), 2,048 in fp32 (4 floats)
    wide = 512 if dtype == torch.bfloat16 else 2048
    gen = torch.Generator(device=device).manual_seed(3)
    x = _randn(gen, 1, 4, wide, 64, dtype=dtype)
    w = _randn(gen, 64, 64, 3, 3, dtype=dtype, scale=(2 / 576) ** .5)
    assert 2 <= cuda_ops.conv3x3_ring(
        cuda_ops.conv3x3_plan(1, 4, wide, 64, 64, dtype), wide) < 4
    assert _rel(cuda_ops.conv3x3_cuda(x, w),
                cuda_ops.conv3x3_ref(x, w)) <= CONV_TOL[dtype]
    g = _randn(gen, 1, 4, wide, 64, dtype=dtype)
    ring = cuda_ops.conv_dw_ring(
        cuda_ops.conv_dw_plan(1, 4, wide, 64, 64, dtype), 4, wide)
    if ring:
        assert ring < 4
        assert _rel(cuda_ops.conv_dw_cuda(x, g),
                    cuda_ops.conv_dw_ref(x, g)) <= DW_TOL[dtype]
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda_ops.conv_dw_cuda(x, g)
    x = _randn(gen, 1, 2, 4096, 64, dtype=dtype)
    assert cuda_ops.conv3x3_ring(
        cuda_ops.conv3x3_plan(1, 2, 4096, 64, 64, dtype), 4096) == 0
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_ops.conv3x3_cuda(x, w)


def _grads(fn, args):
    args = [a.detach().requires_grad_() for a in args]
    out = fn(*args)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(5), device=out.device).to(out.dtype)
    return [out] + list(torch.autograd.grad(out, args, g))


def test_functions_kernel_path_gradients_equal_plain_path(device):
    """Each autograd Function with its kernel against the same Function (or
    plain autograd) on the plain version: outputs and every input's
    gradient within 1e-4 of the largest value (fp32)."""
    gen = torch.Generator(device=device).manual_seed(11)
    x, w = _randn(gen, 256, 16, 4, 64), _randn(gen, 128, 64, 3, 3,
                                               scale=0.05)
    q, k, v = (_randn(gen, 256, 64, 128) for _ in range(3))
    dc = [_randn(gen, 256, 16, 4, 64), _randn(gen, 128, 64, 3, 3,
                                                  scale=0.06),
          _randn(gen, 128, 128, 3, 3, scale=0.04),
          1 + 0.2 * _randn(gen, 128), 0.1 * _randn(gen, 128),
          1 + 0.2 * _randn(gen, 128), 0.1 * _randn(gen, 128),
          1 + 0.2 * _randn(gen, 256, 128), 0.3 * _randn(gen, 256, 128)]
    F = cuda_ops
    pairs = [
        (lambda x, w: F.Conv3x3Kernel.apply(F.conv3x3_cuda, x, w),
         lambda x, w: F.Conv3x3Kernel.apply(F.conv3x3_ref, x, w), (x, w)),
        (lambda x, w: F.Conv3x3T.apply(F.conv_dw_cuda, x, w),
         F.conv3x3_ref, (x, w)),
        (lambda *a: F.DoubleConvKernel.apply(F.double_conv_cuda, False, *a),
         lambda *a: F.double_conv_ref(*a), dc),
        (lambda q, k, v: F.AttentionCore.apply(F.attention_core_cuda, 4, q,
                                               k, v),
         lambda q, k, v: F.attention_core_ref(q, k, v, 4), (q, k, v))]
    for kernel, plain, args in pairs:
        for a, b in zip(_grads(kernel, args), _grads(plain, args)):
            assert _rel(a, b) <= 1e-4


def test_raw_wrappers_refuse_grad_on_the_card(device):
    x = torch.randn((4, 16, 4, 8), device=device, requires_grad=True)
    w = torch.randn((8, 8, 3, 3), device=device)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_ops.conv3x3_cuda(x, w)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_ops.conv_dw_cuda(x, x)
    with torch.no_grad():
        assert cuda_ops.conv_dw_cuda(x, x).shape == (8, 8, 3, 3)
