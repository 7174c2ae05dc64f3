"""Parity of the PyTorch port's data collection and live zarr store with
the JAX package, on CPU, and the port's generate_data entry point.

Collection runs free in both packages: `collect_episodes` on the same
4-track bank (tracks 100-103), 40 steps, `chunk` = `n_steps` (so JAX
compiles one chunk program a driver). Tolerances, those of
tests/test_torch_env.py: episode keys, shapes and dtypes and
`meta/track_seed` equal; positions within POS_ATOL = 1e-3 world units;
frames within FRAME_BUDGET = 30 of 27,648 bytes (as 0..255 levels);
actions within ACTION_ATOL = 1e-3 up to the first step whose action could
have seen a differing frame byte (a flipped lane pixel moves the lane
follower's target by a whole column). Where a run parts, the test prints
the env and step.

The zarr stores are compared array for array, exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_tpu import track as JT
from state_policy_diffusionmodel_tpu.data import collect as jcollect
from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.cli import generate_data
from state_policy_diffusionmodel_torch.data import collect as tcollect
from state_policy_diffusionmodel_torch.data import replay_buffer as trb
from state_policy_diffusionmodel_torch.data.dataset import WindowDataset

from test_torch_policy import torch_threads

POS_ATOL = 1e-3
ACTION_ATOL = 1e-3
FRAME_BUDGET = 30
SEEDS = [100, 101, 102, 103]
N_STEPS = 40


one_torch_thread = torch_threads(1)


@pytest.fixture(scope="module")
def bank4():
    bank = TT.load_or_build_bank(4, bake=True, device="cpu")
    jbank = JT.TrackGeometry(*(jnp.asarray(x.numpy()) for x in bank))
    return bank, jbank


def _collect(bank4, driver, **kw):
    bank, jbank = bank4
    want = jcollect.collect_episodes(SEEDS, driver=driver, n_steps=N_STEPS,
                                     chunk=N_STEPS, geoms=jbank,
                                     return_states=True, **kw)
    got = tcollect.collect_episodes(SEEDS, driver=driver, n_steps=N_STEPS,
                                    chunk=N_STEPS, geoms=bank,
                                    return_states=True, device="cpu", **kw)
    return got, want


def _frame_bytes(a, b):
    """Per step, the count of frame bytes that differ (img is /255)."""
    qa, qb = np.rint(a * 255), np.rint(b * 255)
    return (qa != qb).reshape(len(a), -1).sum(-1)


@pytest.mark.parametrize("driver,kw", [
    ("lane_follow", {"mode": "middle"}), ("lane_follow", {"mode": "right"}),
    ("center_follow", {}), ("sinusoidal", {"amplitude": 13.0})])
def test_collect_episodes_matches_jax(bank4, driver, kw):
    got, want = _collect(bank4, driver, **kw)
    assert len(got) == len(want) == len(SEEDS)
    for b, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        diff = _frame_bytes(g["img"], w["img"])
        assert diff.max() <= FRAME_BUDGET, (b, diff)
        np.testing.assert_allclose(g["position"], w["position"], rtol=0,
                                   atol=POS_ATOL)
        np.testing.assert_allclose(g["car_state"][:, :2],
                                   w["car_state"][:, :2], rtol=0,
                                   atol=POS_ATOL)
        # the action at step t reads the frame of step t-1: hold the
        # actions up to the first step after a differing frame byte
        parted = np.flatnonzero(diff)
        upto = N_STEPS if not len(parted) else parted[0] + 2
        if len(parted):
            print(f"{driver} {kw} env {b}: frames part at step "
                  f"{parted[0]} ({diff[parted[0]]} bytes); actions held "
                  f"to step {upto - 1}")
        np.testing.assert_allclose(g["action"][:upto], w["action"][:upto],
                                   rtol=0, atol=ACTION_ATOL)
        if driver == "sinusoidal":
            np.testing.assert_array_equal(g["h_action"], g["action"])
        assert np.isfinite(g["action"]).all()
    if driver == "lane_follow":
        # the cars drove along the track
        assert min(np.abs(g["position"][-1] - g["position"][0]).sum()
                   for g in got) > 5.0


def test_generate_dataset_matches_jax(bank4):
    """Two modes of four episodes on the bank: the buffer's keys, shapes,
    episode ends and meta/track_seed (one seed an episode, in buffer order)
    equal JAX's; the store saved and read back."""
    bank, jbank = bank4
    kw = dict(episodes_per_mode=4, modes=("middle", "left"),
              n_steps=N_STEPS, chunk=N_STEPS, seed0=43)
    want = jcollect.generate_dataset("", geoms=jbank, **kw)
    got = tcollect.generate_dataset("", geoms=bank, device="cpu", **kw)
    np.testing.assert_array_equal(got.meta["track_seed"],
                                  want.meta["track_seed"])
    np.testing.assert_array_equal(got.meta["track_seed"], np.arange(43, 51))
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert sorted(got.data) == sorted(want.data)
    for k, v in want.data.items():
        assert got.data[k].shape == v.shape and got.data[k].dtype == v.dtype
    np.testing.assert_allclose(got.data["position"], want.data["position"],
                               rtol=0, atol=POS_ATOL)


def _episodes(seed, lengths=(7, 5, 9)):
    rng = np.random.default_rng(seed)
    return [{"img": rng.random((n, 6, 6, 3)).astype(np.float32),
             "position": rng.normal(size=(n, 2)).astype(np.float32),
             "velocity": rng.normal(size=(n, 2)).astype(np.float32),
             "action": rng.normal(size=(n, 3)).astype(np.float32),
             "car_state": rng.normal(size=(n, 30)).astype(np.float32)}
            for n in lengths]


def _assert_same(got, want):
    assert sorted(got.data) == sorted(want.data)
    for k in want.data:
        np.testing.assert_array_equal(np.asarray(got.data[k]),
                                      np.asarray(want.data[k]), err_msg=k)
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert sorted(got.meta) == sorted(want.meta)
    for k in want.meta:
        np.testing.assert_array_equal(got.meta[k], want.meta[k])


@pytest.mark.parametrize("codec", ["default", "zlib", "none"])
def test_port_live_store_loads_in_jax(tmp_path, codec):
    """Three episodes appended (chunks of 4 rows, so chunks straddle
    episodes), reopened, one dropped and one appended again: the store
    reads the same in the JAX package's load_zarr, in the port's, and
    through the live store's own lazy reads. By default it is the JAX
    store's blosc zstd-5 with bitshuffle; zlib and no compressor when
    asked for."""
    path = str(tmp_path / "live.zarr")
    keys = ("img", "position", "velocity", "action", "car_state")
    comp = {"default": None,
            "zlib": {k: {"id": "zlib", "level": 1} for k in keys},
            "none": {k: None for k in keys}}[codec]
    eps = _episodes(1)
    ref = trb.ReplayBuffer()
    z = trb.ZarrReplayBuffer.create_empty_zarr(path, compressors=comp,
                                               chunk_length=4)
    for ep in eps:
        z.add_episode(ep)
        ref.add_episode(ep)
    z = trb.ZarrReplayBuffer(path, compressors=comp)      # reopened
    assert z.n_episodes == 3 and z.n_steps == 21
    for i in range(3):
        for k, v in ref.get_episode(i).items():
            np.testing.assert_array_equal(z.get_episode(i)[k], v)
    for k, v in ref.get_steps_slice(5, 14).items():
        np.testing.assert_array_equal(z.get_steps_slice(5, 14)[k], v)
    z.drop_episode()
    ref.drop_episode()
    z.add_episode(eps[1])
    ref.add_episode(eps[1])
    z.meta["track_seed"] = np.array([7, 8, 9], np.int64)
    z.save_meta()
    ref.meta["track_seed"] = z.meta["track_seed"]
    meta = trb._array_meta(trb._DirStore(path), "data/img")
    assert meta["compressor"] == {
        "default": {"blocksize": 0, "clevel": 5, "cname": "zstd",
                    "id": "blosc", "shuffle": 2},
        "zlib": {"id": "zlib", "level": 1}, "none": None}[codec]
    assert meta["shape"][0] == 17 and meta["chunks"][0] == 4
    # no chunk file past the end: 17 rows of 4 are five chunks
    assert sorted(f for f in os.listdir(os.path.join(path, "data", "img"))
                  if not f.startswith(".")) == [f"{i}.0.0.0" for i in range(5)]
    _assert_same(jrb.load_zarr(path), ref)
    _assert_same(trb.load_zarr(path), ref)
    # the windowed dataset reads the live store's lazy arrays
    ds = WindowDataset(z, 2, 2, 1)
    assert len(ds) == len(WindowDataset(ref, 2, 2, 1))


def test_jax_zlib_store_loads_in_port(tmp_path):
    """A JAX-written live store with zlib for every key, reopened and
    appended to, reads the same in the port."""
    path = str(tmp_path / "jax.zarr")
    eps = _episodes(2, lengths=(6, 11, 3))
    comp = {k: {"id": "zlib", "level": 1} for k in eps[0]}
    z = jrb.ZarrReplayBuffer(path, compressors=comp, chunk_length=4)
    for ep in eps[:2]:
        z.add_episode(ep)
    z = jrb.ZarrReplayBuffer(path, compressors=comp, chunk_length=4)
    z.add_episode(eps[2])
    want = jrb.load_zarr(path)
    _assert_same(trb.load_zarr(path), want)
    live = trb.ZarrReplayBuffer(path)
    np.testing.assert_array_equal(live.episode_ends, want.episode_ends)
    for k, v in want.data.items():
        np.testing.assert_array_equal(live.get_episode(1)[k], v[6:17])


def test_generate_data_cli_on_cpu_and_without_a_card(tmp_path):
    """The entry point writes the JAX CLI's layout on the CPU; without
    --device cpu it raises when there is no card."""
    args = ["--base_dir", str(tmp_path), "--dataset_name", "tiny",
            "--num_episodes_per_mode", "2", "--modes", "middle", "left",
            "--steps", "12", "--save_states"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate_data.main(args)
    out = generate_data.main(args + ["--device", "cpu"])
    assert out.endswith("tiny_dataset_2_episodes_2_modes.zarr")
    buf = trb.load_zarr(out)
    assert buf.n_episodes == 4 and buf.n_steps == 48
    np.testing.assert_array_equal(buf.meta["track_seed"], [43, 44, 45, 46])
    assert sorted(buf.data) == ["action", "angle", "car_state", "img",
                                "position", "velocity"]
    assert buf.data["img"].shape == (48, 96, 96, 3)
    assert os.path.exists(os.path.join(os.path.dirname(out),
                                       "states_list.pkl"))
    # the JAX package reads the store
    jbuf = jrb.load_zarr(out)
    np.testing.assert_array_equal(jbuf.data["action"], buf.data["action"])
