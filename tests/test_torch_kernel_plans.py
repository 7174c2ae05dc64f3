"""The launch plans of the port's 3x3 conv kernels (K3 `conv3x3_plan`, K6
`conv_dw_plan` in bf16; its fp32 plan is held in test_torch_train_ops.py)
and the kernel build's cache. Plans are plain Python, so they are held
here on the CPU at every r5blend shape of a forward (K3) and of a training
step (K6) at B=256 on an H100's 132 SMs: every output element in exactly
one tile, K covered exactly once by the split, the grid at least one full
wave (127 of the 132 SMs: the grids are powers of two) where K is long
enough to split, and the workspaces the size the kernels write. (The
shared-memory ring is the C launchers' own; the card tests hold it.)
"""

import shutil
import sys

import pytest
import torch

from state_policy_diffusionmodel_torch.kernels import build
from state_policy_diffusionmodel_torch.models import cuda_ops

N_SM, B = 132, 256
# (H, W, Cin, Cout) of the 30 K3 calls of one r5blend U-Net forward (the 15
# DoubleConvs of the conv-kernel path, two convs each), and of the 31 convs
# of a training step whose weight gradient K6 computes
_DC = [(16, 4, 64, 64), (16, 4, 64, 128), (8, 2, 128, 128), (8, 2, 128, 256),
       (4, 1, 256, 256), (4, 1, 256, 256), (4, 1, 256, 512),
       (4, 1, 512, 512), (4, 1, 512, 256), (8, 2, 512, 512),
       (8, 2, 512, 128), (16, 4, 256, 256), (16, 4, 256, 64),
       (32, 8, 128, 128), (32, 8, 128, 64)]
FORWARD_CONVS = [c for H, W, cin, cout in _DC
                 for c in ((H, W, cin, cout), (H, W, cout, cout))]
TRAIN_CONVS = [(32, 8, 64, 64)] + FORWARD_CONVS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,cin,cout", sorted(set(FORWARD_CONVS)))
def test_conv3x3_plan_tiles_splits_and_workspaces(H, W, cin, cout, dtype):
    assert len(FORWARD_CONVS) == 30 and len(set(FORWARD_CONVS)) == 17
    M = B * H * W
    p = cuda_ops.conv3x3_plan(B, H, W, cin, cout, dtype, N_SM)
    # bf16 on the tensor cores at every r5blend shape; three taps at W = 1
    assert p.mma == (dtype == torch.bfloat16)
    assert p.taps == (3 if W == 1 else 9)
    assert p.ck == ((16 if W > 1 else 32) if p.mma else 4)
    # every output element in exactly one tile
    assert (p.m_tiles - 1) * p.bm < M <= p.m_tiles * p.bm
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    # the parts cover the channel slices, so K = taps x Cin, exactly once
    parts = [range(z * p.per_split, min(p.slices, (z + 1) * p.per_split))
             for z in range(p.splits)]
    assert all(parts) and sum(map(len, parts)) == p.slices
    assert p.slices == -(-cin // p.ck) and p.cin_pad == p.slices * p.ck
    # the SMs filled (at least 127 of 132: the power-of-two grid nearest a
    # wave) where the slices allow a split
    most = max(1, p.slices // cuda_ops._CONV_MIN_SLICES[(p.mma, p.taps)])
    assert p.blocks >= 0.96 * N_SM or p.splits == most
    # workspaces: the repacked weights [tap][cin_pad][cout_pad], and one f32
    # partial sum per output element per part
    assert p.cout_pad == p.n_tiles * p.bn
    assert p.wt_elems == 9 * p.cin_pad * p.cout_pad
    assert p.ws_elems == (p.splits * M * cout if p.splits > 1 else 0)


def test_conv3x3_plan_splits_only_to_fill_the_card():
    """At every forward shape in both types the grid fills the card (at
    least 127 blocks) unless K is too short to split further, and splits
    only where the tiles alone leave room: doubling the split would pass
    the blocks the SMs run at once."""
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, cin, cout in set(FORWARD_CONVS):
            p = cuda_ops.conv3x3_plan(B, H, W, cin, cout, dtype, N_SM)
            most = max(1, p.slices // cuda_ops._CONV_MIN_SLICES[
                (p.mma, p.taps)])
            assert p.blocks >= 0.96 * N_SM or p.splits == most, (
                H, W, cin, cout, dtype, p)
            tiles = p.m_tiles * p.n_tiles
            room = (N_SM if p.bm == 256 else 2 * N_SM) if p.mma \
                else 3 * N_SM // 2
            assert tiles * p.splits <= max(room, tiles)
            assert p.splits == 1 or tiles * p.splits * 2 > room or \
                p.splits * 2 > p.slices // cuda_ops._CONV_MIN_SLICES[
                    (p.mma, p.taps)]
            # the 256 x 128 tile only for the three 19-GFLOP convs, 128 x 64
            # only at the 4x1 level
            big = (H, cin, cout) in {(32, 128, 128), (16, 256, 256),
                                     (8, 512, 512)}
            assert (p.bm, p.bn) == ((256, 64) if not p.mma else (256, 128)
                                    if big else (128, 64) if W == 1
                                    else (256, 64))


def test_conv3x3_plan_rules_off_the_path():
    """bf16 outside the tensor-core rule, an unaligned x, ragged shapes and
    a wide image: CUDA cores, tiles covering the output."""
    bf16 = torch.bfloat16
    assert not cuda_ops.conv3x3_plan(3, 32, 8, 10, 24, bf16).mma   # Cin % 16
    assert not cuda_ops.conv3x3_plan(5, 8, 2, 16, 3, bf16).mma     # Cout % 8
    assert not cuda_ops.conv3x3_plan(5, 8, 2, 16, 8, bf16,
                                     aligned=False).mma
    p = cuda_ops.conv3x3_plan(7, 4, 1, 36, 40, torch.float32)
    assert (p.taps, p.bn, p.n_tiles, p.m_tiles) == (3, 64, 1, 1)
    wide = cuda_ops.conv3x3_plan(1, 4, 512, 64, 64, bf16)
    assert wide.mma and (wide.bm, wide.m_tiles, wide.n_tiles) == (128, 16, 1)
    assert wide.taps == 9 and wide.splits == 1


@pytest.mark.parametrize("mma,bm,bn", [(True, 128, 64), (True, 256, 64),
                                       (True, 256, 128), (False, 256, 64)])
@pytest.mark.parametrize("splits", [1, 3, 4, 16, 64])
def test_conv3x3_plan_for_takes_the_given_tile_and_split(mma, bm, bn,
                                                         splits):
    """`_conv3x3_plan_for`, through which `conv3x3_plan` makes its choices
    and tools/sweep_conv_plans.py tries others: the tile as given, parts of
    equal slices covering K once, never more parts than slices."""
    for H, W, cin, cout in set(FORWARD_CONVS):
        p = cuda_ops._conv3x3_plan_for(B, H, W, cin, cout, mma, bm, bn,
                                       splits)
        assert (p.mma, p.bm, p.bn) == (mma, bm, bn)
        assert p.splits <= min(splits, p.slices)
        assert (p.splits - 1) * p.per_split < p.slices \
            <= p.splits * p.per_split
        assert p.ws_elems == (p.splits * B * H * W * cout
                              if p.splits > 1 else 0)
        # the public plan is one of these
        q = cuda_ops.conv3x3_plan(B, H, W, cin, cout, torch.bfloat16
                                  if mma else torch.float32, N_SM)
        assert q == cuda_ops._conv3x3_plan_for(B, H, W, cin, cout, q.mma,
                                               q.bm, q.bn, q.splits)


@pytest.mark.parametrize("H,W,cin,cout", sorted(set(TRAIN_CONVS)))
def test_conv_dw_plan_bf16_tensor_cores(H, W, cin, cout):
    """K6 in bf16 at the 17 training shapes: tensor cores, three taps at
    W = 1, whole 64-pixel steps (at least four a chunk), every pixel in
    exactly one chunk, a full wave, and the workspace the chunks' f32
    partial sums [chunk][Cout][9][Cin]."""
    assert len(TRAIN_CONVS) == 31
    P = B * H * W
    p = cuda_ops.conv_dw_plan(B, H, W, cin, cout, torch.bfloat16, N_SM)
    assert p.mma and p.step == 64 and p.taps == (3 if W == 1 else 9)
    # whole steps, at least four; at most 4,096 pixels, over which the
    # tensor cores' f32 sums stay within 1e-5 of the largest |dw|
    assert p.chunk_pixels % 64 == 0 and 256 <= p.chunk_pixels <= 4096
    assert (p.chunks - 1) * p.chunk_pixels < P <= p.chunks * p.chunk_pixels
    assert p.tiles == -(-cin // 32) * -(-cout // 64)
    assert p.blocks >= 0.96 * N_SM
    assert p == cuda_ops._conv_dw_plan_for(B, H, W, cin, cout, True,
                                           p.chunks)
    # every chunk writes one f32 sum per (co, tap, ci)
    assert p.ws_elems == p.chunks * cout * 9 * cin


def test_conv_dw_plan_rules_off_the_path():
    bf16 = torch.bfloat16
    assert not cuda_ops.conv_dw_plan(5, 7, 3, 20, 12, bf16).mma     # Cin % 8
    assert not cuda_ops.conv_dw_plan(6, 5, 5, 16, 6, bf16).mma      # Cout % 8
    # many channel tiles and many pixels: the chunks stay short on the
    # tensor cores, however few blocks the card asks for
    big = cuda_ops.conv_dw_plan(1024, 32, 8, 512, 512, bf16)
    assert big.chunk_pixels <= 4096 and big.chunks * 4096 >= 1024 * 256
    p = cuda_ops.conv_dw_plan(3, 4, 1, 8, 8, torch.float32)
    assert p.taps == 9 and p.chunks == 1 and p.chunk_pixels == 32


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing csrc/conv_tile.cuh (or any header) gives every library a new
    build key, so build/ never serves a library built on the old header; an
    unchanged tree keeps its keys."""
    for f in build.CSRC_DIR.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build._target(n) for n in build.SOURCES}
    assert before == {n: build._target(n) for n in build.SOURCES}
    header = tmp_path / "conv_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    assert {p.parent for p in after.values()} == {build.BUILD_DIR}


def test_build_keeps_the_nvcc_log_beside_a_cached_library(tmp_path,
                                                           monkeypatch):
    """A library found in build/ comes back with the log of the nvcc run
    that built it (the ptxas report chip_smoke.py prints), not an empty
    one. nvcc is a stand-in script here: it writes its -o file and prints a
    ptxas line."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'library')\n"
        "print('ptxas info    : Used 42 registers, 1024 bytes smem')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_built", {})
    first = build.build_all(["conv_dw"])["conv_dw"]
    assert first.seconds > 0 and "Used 42 registers" in first.log
    monkeypatch.setattr(build, "_built", {})
    again = build.build_all(["conv_dw"])["conv_dw"]
    assert again.seconds == 0.0 and again.path == first.path
    assert again.log == first.log
    assert sorted(p.suffix for p in (tmp_path / "build").iterdir()) == [
        ".log", ".so"]
