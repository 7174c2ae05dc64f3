"""Parity of the PyTorch port's renderer and of K2's plain version with the
JAX package, on CPU.

- K2 (`render/cuda_sampler.py`): the plain version must equal, byte for
  byte, both JAX references on the same camera scalars: the XLA sampler
  `raster._sample_texture_mxu` and the Pallas kernel `sample_banked`, run
  in TPU interpret mode. The texel map is the same float32 arithmetic in
  the same order, and the gather is exact.
- Frames: at most 30 of 27,648 bytes may differ per frame, the budget of
  `tests/test_render_golden.py`: the polygon edge test compares a float32
  cross product against 1e-6, and one ulp of a vertex (sin and cos differ
  by an ulp between XLA and PyTorch on ~5% of angles) moves edge pixels.
  The tests print the counts they see.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu.render import pallas_sampler as jps
from state_policy_diffusionmodel_tpu.render import raster as jr
from state_policy_diffusionmodel_torch import physics as TP
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.render import cuda_sampler as ks
from state_policy_diffusionmodel_torch.render import raster as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
FRAME_BUDGET = 30          # bytes of 27,648 (tests/test_render_golden.py)
PF = float(TT.PLAYFIELD)


@pytest.fixture(scope="module")
def bank4():
    bank = TT.load_or_build_bank(4, bake=True, device="cpu")
    jbank = JT.TrackGeometry(*(jnp.asarray(x.numpy()) for x in bank))
    return bank, jbank


@pytest.fixture(scope="module")
def golden():
    frames = np.load(os.path.join(FIX, "golden_frames.npz"))
    cars = TP.load_pickled_states(os.path.join(FIX, "golden_states.pkl"),
                                  device="cpu")
    geom = TT.build(TT.make_track(11), bake=True, device="cpu")
    return frames, cars, geom


def _poses(n_random, seed, road=None):
    """(cos, sin, pos) float32: random poses over the whole playfield (half
    of them near the centerline points `road`, when given), plus poses on
    its edges and corners and wholly off it."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, n_random + 10)
    pos = rng.uniform(-PF, PF, (n_random + 10, 2))
    if road is not None:
        k = n_random // 2
        pos[:k] = road[rng.integers(0, len(road), k)] + rng.normal(0, 5, (k, 2))
    pos[n_random:] = [[PF, 0.0], [-PF, 120.0], [0.0, PF - 3], [-200, -PF],
                      [PF - 1, PF - 1], [-PF - 20, -PF + 5], [PF + 30, 0.0],
                      [0.0, -PF - 45], [520.0, 480.0], [-900.0, 10.0]]
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            pos.astype(np.float32))


def _planes():
    _, _, rx, ry = tr.pixel_planes("cpu")
    return rx, ry


def test_pixel_planes_equal_jax():
    got = tr.pixel_planes("cpu")
    want = jr._pixel_planes()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tables_equal_jax():
    np.testing.assert_array_equal(tr.PALETTE_U8, jr.PALETTE_U8)
    np.testing.assert_array_equal(tr._SCORE_VALUES, jr._SCORE_VALUES)
    np.testing.assert_array_equal(tr.HULL_POLYS, jr.HULL_POLYS)
    assert tr.CAR_COUNTS == jr.CAR_COUNTS and tr.CAR_WINDING == jr.CAR_WINDING


def test_texel_constants_are_float32_as_jax_makes_them():
    """PLAYFIELD and the texel scale enter the map as float32 values."""
    T = 1024
    x = torch.tensor([1.0], dtype=torch.float32)
    got = ((x + PF) * ks.texel_scale(T)).numpy()
    want = np.asarray((jnp.float32(1.0) + JT.PLAYFIELD)
                      * (T / (2.0 * JT.PLAYFIELD)))
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got[0], want)
    assert np.float32(ks.texel_scale(T)) == np.float32(T / (2.0 * PF))


def test_k2_plain_equals_jax_xla_sampler(bank4):
    """60 random poses plus 10 edge and off-field ones, on all 4 tracks:
    the plain version equals `raster._sample_texture_mxu` exactly."""
    bank, jbank = bank4
    c, s, pos = _poses(60, 0, road=bank.seg_b[0, :200].numpy())
    B = len(c)
    ids = (np.arange(B) % 4).astype(np.int32)
    rx, ry = _planes()
    got = ks.sample_banked(bank.tex, torch.from_numpy(ids),
                           torch.from_numpy(c), torch.from_numpy(s),
                           torch.from_numpy(pos), rx, ry).numpy()
    assert got.shape == (B, 72, 128) and got.dtype == np.int32
    jrx, jry = jnp.asarray(rx.numpy()), jnp.asarray(ry.numpy())
    for b in range(B):
        g = jax.tree.map(lambda x: x[ids[b]], jbank)
        # the map as raster.render writes it, op by op
        px = c[b] * jrx + s[b] * jry + pos[b, 0]
        py = -s[b] * jrx + c[b] * jry + pos[b, 1]
        base, lane = jr._sample_texture_mxu(g, px, py)
        want = np.asarray(base * 8 + lane)
        np.testing.assert_array_equal(got[b], want, err_msg=f"pose {b}")
    assert (got >= 8).any() and (got % 8 > 0).any()     # road and lanes
    assert (got[-3:] == 0).all()


def test_k2_plain_equals_pallas_interpret(bank4, monkeypatch):
    """The Pallas kernel in TPU interpret mode, B=8 (edge and off-field
    poses included): equal to the plain version."""
    bank, jbank = bank4
    c, s, pos = _poses(2, 1)
    sel = np.array([0, 1, 2, 3, 4, 6, 9, 10])
    c, s, pos = c[sel], s[sel], pos[sel]
    ids = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    rx, ry = _planes()
    got = ks.sample_banked_ref(bank.tex, torch.from_numpy(ids),
                               torch.from_numpy(c), torch.from_numpy(s),
                               torch.from_numpy(pos), rx, ry).numpy()
    orig = jps.pl.pallas_call
    monkeypatch.setattr(jps.pl, "pallas_call", functools.partial(
        orig, interpret=pltpu.InterpretParams()))
    want = np.asarray(jps.sample_banked(
        jbank.tex, jnp.asarray(ids), jnp.asarray(c), jnp.asarray(s),
        jnp.asarray(pos), jnp.asarray(rx.numpy()), jnp.asarray(ry.numpy())))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_k2_dispatch_takes_plain_version_on_cpu(bank4):
    bank, _ = bank4
    rx, ry = _planes()
    before = ks.sample_banked.launches
    args = (bank.tex, torch.zeros(2, dtype=torch.int32), torch.ones(2),
            torch.zeros(2), torch.zeros(2, 2), rx, ry)
    torch.testing.assert_close(ks.sample_banked(*args),
                               ks.sample_banked_ref(*args))
    assert ks.sample_banked.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        ks.sample_banked_cuda(*args)


def _count(img, gold):
    return int((np.asarray(img) != np.asarray(gold)).sum())


def test_frames_match_golden(golden):
    """Car states 0..4 of the fixture on track 11, state and augmented
    frames, no overlay or score: within the budget of the JAX test."""
    frames, cars, geom = golden
    bank = TT.stack([geom])
    counts = []
    for i, car in enumerate(cars):
        obs, augm = tr.render(car, bank)
        counts += [_count(obs[0], frames[f"f{i}_obs"]),
                   _count(augm[0], frames[f"f{i}_augm"])]
    print("golden frame byte differences (obs, augm per state):", counts)
    assert max(counts) <= FRAME_BUDGET


def test_overlay_frame_matches_golden(golden):
    frames, cars, geom = golden
    car = cars[-1]
    pts = torch.stack([torch.stack([car.pos[0] + torch.tensor([i * 1.0,
                                                               j * 2.0])
                                    for j in range(5)]) for i in range(3)])
    ov = tr.Overlay(points=pts, valid=torch.tensor([True, True, False]))
    obs, augm = tr.render(car, TT.stack([geom]), overlay=ov)
    counts = [_count(obs[0], frames["f5_obs"]),
              _count(augm[0], frames["f5_augm"])]
    print("overlay frame byte differences:", counts)
    assert max(counts) <= FRAME_BUDGET


def _jcar(car, b=0):
    return jr.CarState(*(jnp.asarray(f[b].numpy()) for f in car))


@pytest.mark.parametrize("score", [None, -37.2, 0.0, 123.4, 1999.6])
def test_render_matches_jax_with_overlay_and_score(golden, score):
    """Port against JAX `render` on every golden state, with an overlay and
    with the score label (None: no label)."""
    _, cars, geom = golden
    jgeom = JT.build(JT.make_track(11), bake=True)
    rend = jax.jit(jr.render)
    counts = []
    for car in cars:
        ov_pts = car.pos[0] + torch.tensor([[[0.0, 0.0], [3.0, 5.0],
                                             [-4.0, 9.0]]])
        ov = tr.Overlay(points=ov_pts, valid=torch.tensor([True]))
        jov = jr.Overlay(points=jnp.asarray(ov_pts.numpy()),
                         valid=jnp.array([True]))
        sc = None if score is None else torch.tensor([score])
        obs, augm = tr.render(car, TT.stack([geom]), overlay=ov, score=sc)
        jobs, jaugm = rend(_jcar(car), jgeom, jov,
                           None if score is None else jnp.float32(score))
        counts += [_count(obs[0], jobs), _count(augm[0], jaugm)]
    print(f"score {score}: byte differences against JAX render:", counts)
    assert max(counts) <= FRAME_BUDGET


def test_render_batch_banked_matches_jax(golden, monkeypatch):
    """B=5 golden states against JAX's vmapped `render_batch_banked` (its
    Pallas sampler in interpret mode), with scores, on a 2-track bank."""
    _, cars, geom = golden
    other = TT.build(TT.make_track(12), bake=True, device="cpu")
    bank = TT.stack([other, geom])
    cars_b = TP.stack_states(cars)
    ids = torch.tensor([1, 1, 0, 1, 0], dtype=torch.int32)
    score = torch.tensor([-12.5, 3.0, 45.6, 789.0, 1000.0])
    obs, augm = tr.render_batch_banked(cars_b, bank.tex, ids, score=score)
    orig = jps.pl.pallas_call
    monkeypatch.setattr(jps.pl, "pallas_call", functools.partial(
        orig, interpret=pltpu.InterpretParams()))
    jcars = jr.CarState(*(jnp.asarray(f.numpy()) for f in cars_b))
    jobs, jaugm = jr.render_batch_banked(
        jcars, jnp.asarray(bank.tex.numpy()), jnp.asarray(ids.numpy()),
        score=jnp.asarray(score.numpy()))
    counts = [(_count(obs[b], jobs[b]), _count(augm[b], jaugm[b]))
              for b in range(5)]
    print("render_batch_banked byte differences:", counts)
    assert max(max(c) for c in counts) <= FRAME_BUDGET
    assert obs.shape == (5, 96, 96, 3) and obs.dtype == torch.uint8


def test_score_glyphs_of_neighbouring_slots_colour_black():
    """Where two neighbouring glyphs both light a pixel the JAX layer index
    is 2 * L_SCORE, which its one-hot colorize has no row for: black."""
    band = tr._score_band(torch.tensor([8888.0]))[0].numpy()
    want = np.asarray(jr._score_band(jnp.float32(8888.0)))
    np.testing.assert_array_equal(band, want)
    layer = np.zeros((72, 128), np.int32)
    layer[50:72] = band
    jrgb = np.asarray(jr._colorize_matmul(jnp.asarray(layer)))
    pal = tr._device_tables(torch.device("cpu"))["palette"]
    got = pal[torch.from_numpy(layer)].reshape(96, 96, 3).numpy()
    np.testing.assert_array_equal(got, jrgb)


def test_camera_matches_jax():
    from state_policy_diffusionmodel_tpu.render import camera as jcam
    from state_policy_diffusionmodel_torch.render import camera as tcam

    rng = np.random.default_rng(3)
    ang = rng.uniform(-3, 3, 16).astype(np.float32)
    vel = rng.normal(0, 2, (16, 2)).astype(np.float32)
    vel[:4] *= 0.1                      # slow cars keep the hull angle
    np.testing.assert_array_equal(
        tcam.camera_angle(torch.from_numpy(ang), torch.from_numpy(vel)),
        np.asarray(jax.vmap(jcam.camera_angle)(jnp.asarray(ang),
                                                jnp.asarray(vel))))
    p = rng.uniform(-50, 50, (16, 5, 2)).astype(np.float32)
    scroll = rng.uniform(-50, 50, (16, 2)).astype(np.float32)
    args_t = (torch.from_numpy(p), torch.from_numpy(scroll)[:, None],
              torch.from_numpy(ang)[:, None])
    want = jax.vmap(jcam.world_to_window)(jnp.asarray(p),
                                          jnp.asarray(scroll),
                                          jnp.asarray(ang))
    got = tcam.world_to_window(*args_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)       # sin/cos ulps x zoom x 50
    back = tcam.window_to_world(got, *args_t[1:])
    np.testing.assert_allclose(back.numpy(), p, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tcam.pixel_window_centers("cpu").numpy(),
                                  np.asarray(jcam.pixel_window_centers()))


def test_pixel_world_coords_matches_jax():
    """The world point under every pixel centre, for a batch of cameras
    and for one, against the JAX function vmapped."""
    from state_policy_diffusionmodel_tpu.render import camera as jcam
    from state_policy_diffusionmodel_torch.render import camera as tcam

    rng = np.random.default_rng(4)
    ang = rng.uniform(-3, 3, 8).astype(np.float32)
    scroll = rng.uniform(-50, 50, (8, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(jcam.pixel_world_coords)(
        jnp.asarray(scroll), jnp.asarray(ang)))
    got = tcam.pixel_world_coords(torch.from_numpy(scroll),
                                  torch.from_numpy(ang))
    assert got.shape == (8, 96, 96, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    one = tcam.pixel_world_coords(torch.from_numpy(scroll[3]),
                                  torch.tensor(ang[3]))
    assert one.shape == (96, 96, 2)
    np.testing.assert_allclose(one.numpy(), want[3], rtol=0, atol=1e-4)
