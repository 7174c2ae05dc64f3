"""The launch plans of the port's 3x3 conv kernels (K3 `conv3x3_plan`, K6
`conv_dw_plan` in bf16; its fp32 plan is held in test_torch_train_ops.py),
of K4 (`gn_act_plan`, with a model of its summation order) and K2
(`sample_banked_plan`), and the kernel build's cache. Plans are plain Python, so they are held
here on the CPU at every r5blend shape of a forward (K3) and of a training
step (K6) at B=256 on an H100's 132 SMs: every output element in exactly
one tile, K covered exactly once by the split, the grid at least one full
wave (127 of the 132 SMs: the grids are powers of two) where K is long
enough to split, and the workspaces the size the kernels write. (The
shared-memory ring is the C launchers' own; the card tests hold it.)
"""

import math
import shutil
import sys

import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_torch.kernels import build
from state_policy_diffusionmodel_torch.models import cuda_ops
from state_policy_diffusionmodel_torch.render import cuda_sampler

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


# ---------------------------------------------------------------------------
# K4: gn_act_plan and its summation order
# ---------------------------------------------------------------------------

# (H, W, C) of the 10 distinct K4 shapes of one r5blend forward (B=256)
GN_SHAPES = sorted({(H, W, cout) for H, W, _, cout in _DC})
# off the path: B=1, HW=1, C=12 (16-byte packs in fp32 only) and 6 (in
# neither), C=96 (a team of 96 threads), a slice of 2,048 passes, and C
# whose packs cannot keep a thread's channels fixed
GN_EDGES = [(1, 256, 128), (1, 1, 12), (3, 15, 12), (5, 15, 6), (5, 4, 96),
            (2, 1 << 16, 64), (2, 1, 16384), (7, 3, 1000)]
# K4 against its plain version (chip_smoke.py's CONV_TOL)
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _gn_owners(plan, HW, C):
    """How many threads own each pack of one batch element: pack
    (it * nv + k) * team + t for every pass, slot and thread of the team."""
    it, k, t = np.meshgrid(np.arange(plan.iters), np.arange(plan.nv),
                           np.arange(plan.team), indexing="ij")
    p = ((it * plan.nv + k) * plan.team + t).ravel()
    packs = HW * C // plan.pack
    return np.bincount(p[p < packs], minlength=packs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,HW,C", [(256, H * W, C) for H, W, C in GN_SHAPES]
                         + GN_EDGES)
def test_gn_act_plan_owns_every_value_once_and_fits(B, HW, C, dtype):
    """Every value of a batch element is one thread's, no pass is empty;
    the grid holds every batch element (packed teams, the last CTA's teams
    past B idle); a CTA and the packs a thread holds fit the kernel (256
    threads, at most eight packs: 32 registers); with wide packs (16
    bytes, or 8 for a bf16 slice of fewer than 256 16-byte packs) a
    thread's channels stay fixed (team x pack a multiple of C); r5blend's
    shapes take up to 16 values a thread a pass."""
    assert len(GN_SHAPES) == 10
    plan = cuda_ops.gn_act_plan(B, HW, C, dtype)
    esize = torch.tensor([], dtype=dtype).element_size()
    assert (_gn_owners(plan, HW, C) == 1).all()
    assert plan.pack * (HW * C // plan.pack) == HW * C
    assert (plan.iters - 1) * plan.nv * plan.team * plan.pack < HW * C
    assert plan.team % 32 == 0 and plan.threads <= 256
    assert plan.nv in (1, 2, 4, 8)
    assert plan.grid * plan.per_cta >= B > (plan.grid - 1) * plan.per_cta
    if plan.vec:
        wide = 16 // esize
        assert plan.pack == wide or (
            plan.pack == 4 and wide == 8 and HW * C // wide < 256)
        assert C % plan.pack == 0 and plan.team * plan.pack % C == 0
    else:
        assert plan.pack == 1
    if (HW, C) in {(H * W, C) for H, W, C in GN_SHAPES}:
        # threads first (256, or a pack each), then up to 16 values each
        assert plan.vec and plan.nv * plan.pack <= 16
        assert plan.team == 256 or plan.team * plan.pack == HW * C
    # an unaligned x takes one-value packs
    assert not cuda_ops.gn_act_plan(B, HW, C, dtype, False).vec


def test_gn_act_plan_branches():
    """The plan's branches: a pack a thread where the slice has at most 256
    (bf16 4x1x256: 8-byte packs, 256 threads of 4 values, as fp32's),
    up to 16 values a thread on 256 threads read once (16x4x64), passes
    beyond (8 at 32x8x128), and teams of fewer than 128 threads packed into
    one CTA (a slice of 256 bf16 values: 64 8-byte packs, two teams a
    CTA)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        p = cuda_ops.gn_act_plan(256, 4, 256, dtype)
        assert (p.pack, p.team, p.nv, p.per_cta, p.iters) == (4, 256, 1, 1, 1)
    assert cuda_ops.gn_act_plan(256, 4, 512, bf16).pack == 8
    for dtype in (f32, bf16):
        p = cuda_ops.gn_act_plan(256, 64, 64, dtype)
        assert (p.team, p.nv * p.pack, p.iters) == (256, 16, 1)
        assert cuda_ops.gn_act_plan(256, 256, 128, dtype).iters == 8
    p = cuda_ops.gn_act_plan(5, 4, 64, bf16)
    assert (p.pack, p.team, p.per_cta, p.grid) == (4, 64, 2, 3)


def _gn_sums(x, plan, acc=torch.float64):
    """K4's two sums of each batch element of x under `plan`: each thread
    adds its values and their squares in pack order in `acc` (the kernel:
    double, where the squares are exact) and rounds both to f32, a warp
    adds its lanes by an xor butterfly, a team its warps in order, in
    f32. Returns (sum, sum of squares), each (B,) f32."""
    B, H, W, C = x.shape
    n, e = H * W * C, plan.pack
    G = plan.team
    xf = torch.zeros(B, plan.iters * plan.nv * G * e)
    xf[:, :n] = x.float().reshape(B, n)
    seq = xf.reshape(B, plan.iters * plan.nv, G, e).permute(0, 2, 1, 3) \
        .reshape(B, G, -1)
    sd = qd = torch.zeros(B, G, dtype=acc)
    for i in range(seq.shape[-1]):
        v = seq[..., i].to(acc)
        sd, qd = sd + v, qd + v * v
    s, q = sd.float(), qd.float()
    lanes = torch.arange(32)

    def across(a):
        a = a.reshape(B, G // 32, 32)
        for off in (16, 8, 4, 2, 1):
            a = a + a[..., lanes ^ off]
        t = torch.zeros(B)
        for w in range(G // 32):
            t = t + a[:, w, 0]
        return t

    return across(s), across(q)


def _gn_model(x, gamma, beta, ps, pb, x_res, gelu, plan):
    """K4 in plain torch with the kernel's two sums (`_gn_sums`), then the
    statistics and the epilogue of gn_act_ref."""
    B, H, W, C = x.shape
    n = H * W * C
    s, q = (t[:, None, None] for t in _gn_sums(x, plan))
    m = s / n
    rs = torch.rsqrt((q / n - m * m).clamp_min(0.0) + cuda_ops.GN_EPS)
    y = (x.float().reshape(B, H * W, C) - m) * rs * gamma.float() \
        + beta.float()
    if gelu:
        y = cuda_ops.gelu_exact(y)
    if ps is not None:
        y = y * ps.float()[:, None, :] + pb.float()[:, None, :]
    if x_res is not None:
        y = cuda_ops.gelu_exact(y + x_res.float().reshape(B, H * W, C))
    return y.to(x.dtype).reshape(B, H, W, C)


@pytest.fixture()
def warm_erf():
    """The first torch.erf call of a process can return, for one thread's
    chunk, values that saturate at -1 where later calls do not (PyTorch
    2.13's CPU build), which moves GELU's far tail by ~6e-5 of the largest
    output; one call first makes the model and the plain version take the
    same erf."""
    torch.erf(torch.linspace(-6.0, 6.0, 1 << 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C", GN_SHAPES)
def test_gn_act_summation_order_model_matches_plain(warm_erf, H, W, C,
                                                    dtype):
    """The kernel's fixed summation order (modelled on the CPU under the
    plan r5blend's B=256 gets) stays within CONV_TOL of gn_act_ref in every
    variant."""
    gen = torch.Generator().manual_seed(H * W * C)
    B = 2
    r = lambda *shape: torch.randn(shape, generator=gen)
    x, g, b = 2 * r(B, H, W, C) + 0.5, 1 + 0.3 * r(C), 0.2 * r(C)
    ps, pb, xr = 1 + 0.2 * r(B, C), 0.3 * r(B, C), r(B, H, W, C)
    x, g, b, ps, pb, xr = (t.to(dtype) for t in (x, g, b, ps, pb, xr))
    plan = cuda_ops.gn_act_plan(256, H * W, C, dtype)
    for args in ((x, g, b, None, None, None, False),
                 (x, g, b, None, None, None, True),
                 (x, g, b, ps, pb, None, False), (x, g, b, ps, pb, xr, False)):
        got = _gn_model(*args, plan).float()
        want = cuda_ops.gn_act_ref(*args).float()
        assert (got - want).abs().max() / want.abs().max() \
            <= CONV_TOL[dtype], args[3:]


# ---------------------------------------------------------------------------
# K2: sample_banked_plan
# ---------------------------------------------------------------------------


# the fast variance's resolution: float32 ulps of E[x^2]
GN_VAR_ULPS = 10


@pytest.mark.parametrize("H,W,C", GN_SHAPES)
def test_gn_act_sums_hold_the_variance_where_the_mean_is_far_off(H, W, C):
    """On slices whose mean is 16 standard deviations, K4's statistics in
    its sum order (`_gn_sums` under the plan r5blend's B=256 gets, then
    the fast variance E[x^2] - m^2 in f32, as the reference computes it)
    with the kernel's double per-thread sums lie within GN_VAR_ULPS f32
    ulps of E[x^2] of float64's variance: 256 slices of noise and 256 of
    per-channel constants (a conv's output on a spatially constant input),
    each mean drawn from [0.5, 4.5]. f32 per-thread sums in the same order
    miss that bound at the two largest slices (32x8: 64 and 128 values a
    thread) on the per-channel constants; on noise, and at the smaller
    slices, the f32 roundings of the sums and of the formula, which both
    orders share, set the error."""
    plan = cuda_ops.gn_act_plan(256, H * W, C, torch.float32)
    gen = torch.Generator().manual_seed(H * W * C)
    B, n = 256, H * W * C
    worst = {}
    for kind in ("noise", "per-channel"):
        c = torch.rand(B, 1, generator=gen, dtype=torch.float64) * 4 + 0.5
        z = torch.randn((B, H, W, C) if kind == "noise" else (B, 1, 1, C),
                        generator=gen, dtype=torch.float64)
        z = z.expand(B, H, W, C).reshape(B, n)
        z = (z - z.mean(1, keepdim=True)) / z.std(1, unbiased=False,
                                                  keepdim=True)
        x = (c * (1 + z / 16)).float().reshape(B, H, W, C)
        xd = x.double().reshape(B, n)
        exact = ((xd - xd.mean(1, keepdim=True)) ** 2).mean(1)
        assert (xd.mean(1) >= 15.99 * exact.sqrt()).all()
        ulp = (xd * xd).mean(1) * 2.0 ** -24
        for acc in (torch.float64, torch.float32):
            s, q = _gn_sums(x, plan, acc)
            m = s / n
            var = (q / n - m * m).double()
            worst[kind, acc] = ((var - exact).abs() / ulp).max().item()
    for kind in ("noise", "per-channel"):
        assert worst[kind, torch.float64] <= GN_VAR_ULPS, worst
    if H == 32:
        assert worst["per-channel", torch.float32] > GN_VAR_ULPS, worst

@pytest.mark.parametrize("B", [1, 255, 256, 1024, 1025])
def test_sample_banked_plan_covers_every_pixel_once(B):
    """Every (env, pixel) is rendered by exactly one thread of one CTA, the
    grid within what the SMs hold at once (8 CTAs of 256 threads each)."""
    groups = cuda_sampler.sample_banked_plan(B, N_SM)
    pixels = cuda_sampler.ROWS * cuda_sampler.LANES
    strips = cuda_sampler.STRIPS
    assert strips * cuda_sampler.THREADS * cuda_sampler.PIXELS_A_THREAD \
        == pixels == 9216
    assert groups * strips <= N_SM * 8 and 1 <= groups <= B
    count = np.zeros((B, pixels), np.int64)
    tid = np.arange(cuda_sampler.THREADS)
    w, lane = tid // 32, tid % 32
    for cta in range(groups * strips):
        strip, group = cta % strips, cta // strips
        # the kernel's pixel_of: warp w, lane l of the strip
        p0 = (strip * 8 + lane // 4) * cuda_sampler.LANES + w * 16 \
            + 4 * (lane % 4)
        p = (p0[:, None] + np.arange(4)).ravel()
        count[group::groups, p] += 1
    assert (count == 1).all()
