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
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
