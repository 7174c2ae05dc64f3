"""Parity of the PyTorch port's track generator, texture bake and track
geometry with the JAX package, on CPU.

The generator and the bake are numpy in both packages: their outputs must
be byte-identical. The geometry is float32 in both; the nearest-segment
query takes the same float32 operations in the same order, so against JAX
run op by op (vmap without jit) indices are equal and distances agree to
1e-6 (they read equal on this CPU). Under jit, XLA fuses the elementwise
chain and its contractions move distances by up to ~7e-6, so the
reference here is the unfused one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.track import geometry as tgeo
from state_policy_diffusionmodel_torch.track import generator as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".cache_tracks")


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 100, 113])
def test_generator_byte_identical(seed):
    want, got = JT.make_track(seed), TT.make_track(seed)
    assert got.n == want.n and got.seed == want.seed
    for field in ("xy", "beta", "border", "start"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    np.testing.assert_array_equal(TT.lane_points(got), JT.lane_points(want))
    np.testing.assert_array_equal(TT.tile_quads(got), JT.tile_quads(want))


@pytest.mark.parametrize("seed,tex_size", [(11, 1024), (3, 256), (104, 512)])
def test_texture_byte_identical(seed, tex_size):
    got = TT.bake_texture(TT.make_track(seed), tex_size)
    want = JT.bake_texture(JT.make_track(seed), tex_size)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert (got[..., 0] > 0).mean() > 0.01     # the road is drawn


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_geom_equal(got, want):
    for field in TT.TrackGeometry._fields:
        a, b = _np(getattr(got, field)), _np(getattr(want, field))
        assert a.dtype == b.dtype, (field, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("seed,bake", [(11, True), (5, False)])
def test_build_matches_jax(seed, bake):
    got = TT.build(TT.make_track(seed), bake=bake, device="cpu")
    want = JT.build(JT.make_track(seed), bake=bake)
    _assert_geom_equal(got, want)


def test_build_casts_to_float32_as_jax_does():
    """The generator's arrays and a float64 start go through `build` as
    float32 tensors, as jnp.asarray makes them with x64 off."""
    tr = TT.make_track(2)
    tr.start = tr.start.astype(np.float64)
    g = TT.build(tr, bake=False, device="cpu")
    assert {getattr(g, f).dtype for f in ("seg_a", "seg_b", "beta", "start")} \
        == {torch.float32}
    assert g.n.dtype == torch.int32 and g.valid.dtype == torch.bool
    assert g.tex.dtype == torch.uint8
    assert jnp.asarray(tr.start).dtype == jnp.float32


@pytest.mark.parametrize("n_unique", [4, 16])
def test_bank_cache_matches_build(n_unique):
    """load_or_build_bank reads .cache_tracks/bank{U}_1.npz; the port's own
    build of tracks 100.. reproduces those files exactly."""
    path = os.path.join(CACHE, f"bank{n_unique}_1.npz")
    assert os.path.exists(path)
    bank = TT.load_or_build_bank(n_unique, bake=True, device="cpu")
    with np.load(path, allow_pickle=False) as z:
        for field in TT.TrackGeometry._fields:
            np.testing.assert_array_equal(_np(getattr(bank, field)), z[field])
    built = TT.stack([TT.build(TT.make_track(100 + i), bake=True,
                               device="cpu") for i in range(n_unique)])
    _assert_geom_equal(built, bank)


def test_bank_builds_when_not_cached(tmp_path, monkeypatch):
    monkeypatch.setattr(tgeo, "CACHE_DIR", str(tmp_path))
    bank = TT.load_or_build_bank(2, bake=False, device="cpu")
    want = JT.stack([JT.build(JT.make_track(100 + i), bake=False)
                     for i in range(2)])
    _assert_geom_equal(bank, want)
    assert not os.listdir(tmp_path)            # nothing written


def _bank4():
    bank = TT.load_or_build_bank(4, bake=True, device="cpu")
    jbank = JT.TrackGeometry(*(jnp.asarray(_np(x)) for x in bank))
    return bank, jbank


def test_nearest_segment_matches_jax():
    bank, jbank = _bank4()
    rng = np.random.default_rng(0)
    B, K = 24, 4
    ids = (np.arange(B) % 4).astype(np.int32)
    # points near the centerlines, and some far out
    start = _np(bank.seg_b)[ids, rng.integers(0, 200, size=B)]
    p = (start[:, None] + rng.normal(0, 8, size=(B, K, 2))).astype(np.float32)
    p[-3:] = rng.uniform(-400, 400, size=(3, K, 2))
    got = TT.nearest_segment(bank, torch.from_numpy(ids), torch.from_numpy(p))

    def one(t, q):
        g = jax.tree.map(lambda x: x[t], jbank)
        return jax.vmap(lambda pt: JT.nearest_segment(g, pt))(q)

    want = jax.vmap(one)(jnp.asarray(ids), jnp.asarray(p))
    np.testing.assert_array_equal(_np(got.idx), np.asarray(want.idx))
    for field in ("dist", "lateral", "tangent", "closest"):
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    assert _np(TT.on_road(got.dist)).any() and not _np(
        TT.on_road(got.dist)).all()


def test_sample_texture_matches_jax():
    bank, jbank = _bank4()
    rng = np.random.default_rng(1)
    ids = np.array([0, 1, 2, 3, 1], np.int32)
    p = rng.uniform(-340, 340, size=(5, 300, 2)).astype(np.float32)
    got = TT.sample_texture(bank, torch.from_numpy(ids), torch.from_numpy(p))
    for b, t in enumerate(ids):
        g = jax.tree.map(lambda x: x[t], jbank)
        want = JT.sample_texture(g, jnp.asarray(p[b]))
        np.testing.assert_array_equal(_np(got[0][b]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1][b]), np.asarray(want[1]))


def test_playfield_constants_are_the_jax_ones():
    assert tgen.PLAYFIELD == JT.PLAYFIELD and tgen.TRACK_WIDTH == JT.TRACK_WIDTH
    np.testing.assert_array_equal(tgen.LANE_OFFSETS, JT.LANE_OFFSETS)
