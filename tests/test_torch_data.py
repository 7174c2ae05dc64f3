"""The port's data path against the JAX package's, on CPU: normalization,
windows, statistics, batches, the device twin, the data module's split and
order, the zarr store in both directions and the STATS.pkl sidecar.

The committed store `data/eval_shared/...zarr` is blosc-zstd compressed,
which the port reads through its own zstd decoder (tests/test_torch_blosc.py
and tests/test_torch_zstd.py hold its reader): its first two episodes are
read here through the JAX package's own lazy tensorstore views and handed
as (data, episode_ends) to both packages. The whole store (1.3 GB of
float32 frames) is compared in one `slow` test.

Tolerances: statistics, indices, splits and orders exactly equal; batch
windows and the device twin within 1 ulp of float32 (the twin runs the
same formulas as torch ops; on a card a division by a Python scalar becomes
a multiply by its reciprocal, as XLA's does in the JAX twin).
"""

import os
import pathlib
import pickle

import numpy as np
import pytest
import tensorstore
import torch

from state_policy_diffusionmodel_tpu.data import dataset as jds
from state_policy_diffusionmodel_tpu.data import normalize as jn
from state_policy_diffusionmodel_tpu.data import replay_buffer as jr
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.data import normalize as tn
from state_policy_diffusionmodel_torch.data import replay_buffer as tr

REPO = pathlib.Path(__file__).resolve().parents[1]
STORE = str(REPO / "data" / "eval_shared"
            / "shared_eval_dataset_6_episodes_3_drivers.zarr")
KEYS = ("img", "position", "velocity", "action")
OBS, PRED, STEP = 10, 30, 5


def _read_store(n_episodes=None):
    """(data, episode_ends) of the committed store's first episodes, read
    through the JAX package's tensorstore views (no write to the store)."""
    view = lambda k: jr._TSView(tensorstore.open(jr._ts_spec(STORE, k))
                                .result())
    ends = np.asarray(view("meta/episode_ends")[:], np.int64)
    if n_episodes is not None:
        ends = ends[:n_episodes]
    n = int(ends[-1])
    return {k: view(f"data/{k}")[:n] for k in KEYS}, ends


def _ulp_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.fixture(scope="module")
def two_episodes():
    data, ends = _read_store(2)
    return (data, ends,
            jds.WindowDataset((data, ends), OBS, PRED, STEP),
            tds.WindowDataset((data, ends), OBS, PRED, STEP))


def _stats_equal(a, b):
    for key in ("position", "velocity", "action"):
        for side in ("min", "max"):
            np.testing.assert_array_equal(a[key][side], b[key][side])
            assert np.asarray(a[key][side]).dtype == \
                np.asarray(b[key][side]).dtype


# ---------------------------------------------------------------------------
# normalize.py, function by function
# ---------------------------------------------------------------------------

def test_normalize_functions_match():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(50, 3)).astype(np.float32)
    data[:, 2] = 1.5                                  # a zero-range dim
    st_j, st_t = jn.get_data_stats(data), tn.get_data_stats(data)
    for k in ("min", "max"):
        np.testing.assert_array_equal(st_t[k], st_j[k])
    nd = tn.normalize_data(data, st_t)
    np.testing.assert_array_equal(nd, jn.normalize_data(data, st_j))
    assert np.all(nd[:, 2] == -1.0)                   # the guard
    np.testing.assert_array_equal(tn.unnormalize_data(nd, st_t),
                                  jn.unnormalize_data(nd, st_j))
    pstats = {"min": np.float32(-3.0), "max": np.float32(4.5)}
    for sample in (data[:12, :2], data[:24, :2].reshape(2, 12, 2)):
        (a, ta), (b, tb) = (tn.normalize_position(sample, pstats),
                            jn.normalize_position(sample, pstats))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(
            tn.unnormalize_position(a, ta, pstats),
            jn.unnormalize_position(b, tb, pstats))
    ends = np.array([40, 95, 150])
    for pad in ((0, 0), (2, 3)):
        np.testing.assert_array_equal(
            tn.create_sample_indices(ends, 12, *pad),
            jn.create_sample_indices(ends, 12, *pad))
    arrs = {"a": data, "b": data[:, :1]}
    for got, want in zip(
            tn.sample_sequence(arrs, 12, 30, 40, 2, 12).values(),
            jn.sample_sequence(arrs, 12, 30, 40, 2, 12).values()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tn.sample_sequence_sparse(arrs, 5, 3, 40).values(),
                         jn.sample_sequence_sparse(arrs, 5, 3, 40).values()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seq,step", [(40, 5), (12, 1), (8, 3)])
def test_create_sample_indices_sparse_identical(seq, step):
    ends = np.array([230, 231, 500, 2000])
    got = tn.create_sample_indices_sparse(ends, seq, step)
    want = jn.create_sample_indices_sparse(ends, seq, step)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# WindowDataset, batches and the device twin on the committed store
# ---------------------------------------------------------------------------

def test_window_dataset_stats_and_indices_equal(two_episodes):
    _, _, jw, tw = two_episodes
    np.testing.assert_array_equal(tw.indices, jw.indices)
    _stats_equal(tw.stats, jw.stats)
    for k in ("position", "velocity", "action", "image"):
        np.testing.assert_array_equal(tw.train_data[k], jw.train_data[k])
    for i in (0, 17, len(jw) - 1):
        np.testing.assert_array_equal(tw.get_window(i)["position"],
                                      jw.get_window(i)["position"])


def test_window_dataset_batches_match(two_episodes):
    _, _, jw, tw = two_episodes
    idx = np.random.default_rng(1).choice(len(jw), 64, replace=False)
    want, want_tr = jw.batch(idx, return_translations=True)
    got, got_tr = tw.batch(idx, return_translations=True)
    assert set(got) == set(want)
    for k in want:
        _ulp_close(got[k], want[k])
    _ulp_close(got_tr, want_tr)
    # the first obs_horizon image frames only
    few = tw.batch(idx, image_frames=OBS)["image"]
    np.testing.assert_array_equal(few, got["image"][:, :OBS])


def test_inference_mode_window_matches(two_episodes):
    data, ends, jw, _ = two_episodes
    jinf = jds.WindowDataset((data, ends), OBS, PRED, STEP, stats=jw.stats)
    tinf = tds.WindowDataset((data, ends), OBS, PRED, STEP, stats=jw.stats)
    for i in (3, 400):
        (ts_, ttr, t0, t1), (js_, jtr, j0, j1) = (tinf.get_window(i),
                                                  jinf.get_window(i))
        assert (t0, t1) == (j0, j1)
        np.testing.assert_array_equal(ttr, jtr)
        for k in js_:
            np.testing.assert_array_equal(ts_[k], js_[k])


def test_device_twin_on_cpu_matches_window_batch(two_episodes):
    """The device twin on CPU tensors: the committed frames are k/255, so
    the twin keeps them as uint8, and its windows equal WindowDataset.batch
    within 1 ulp (exactly on the CPU, where torch divides as numpy does)."""
    _, _, jw, tw = two_episodes
    twin = tds.DeviceWindowDataset(tw, device="cpu")
    assert twin._data["image"].dtype == torch.uint8
    idx = np.random.default_rng(2).choice(len(tw), 32, replace=False)
    want = jw.batch(idx)
    got = twin.batch(torch.from_numpy(idx))
    for k in want:
        _ulp_close(got[k].numpy(), want[k])
    np.testing.assert_array_equal(
        twin.batch(idx, image_frames=OBS)["image"].numpy(),
        got["image"][:, :OBS].numpy())


@pytest.mark.slow
def test_whole_store_windows_and_stats_match():
    """All six episodes of the committed store (12,000 frames)."""
    data, ends = _read_store()
    jw = jds.WindowDataset((data, ends), OBS, PRED, STEP)
    tw = tds.WindowDataset((data, ends), OBS, PRED, STEP)
    np.testing.assert_array_equal(tw.indices, jw.indices)
    _stats_equal(tw.stats, jw.stats)
    rng = np.random.default_rng(3)
    for _ in range(4):
        idx = rng.choice(len(jw), 256, replace=False)
        want, got = jw.batch(idx), tw.batch(idx)
        for k in want:
            _ulp_close(got[k], want[k])
    twin = tds.DeviceWindowDataset(tw, device="cpu")
    got = twin.batch(idx)
    for k in want:
        _ulp_close(got[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# the data module, the zarr store and STATS.pkl in both directions
# ---------------------------------------------------------------------------

def _synthetic(rng, lengths=(230, 260, 215)):
    buf = tr.ReplayBuffer()
    for L in lengths:
        buf.add_episode({
            "img": rng.integers(0, 256, (L, 8, 8, 3), dtype=np.uint8),
            "position": np.cumsum(rng.normal(size=(L, 2)), 0)
            .astype(np.float32),
            "velocity": rng.normal(size=(L, 2)).astype(np.float32),
            "action": rng.uniform(-1, 1, (L, 3)).astype(np.float32)})
    buf.meta["track_seed"] = np.arange(len(lengths), dtype=np.int64)
    return buf


def test_data_module_split_and_batch_order_identical(tmp_path):
    buf = _synthetic(np.random.default_rng(4))
    tr.save_zarr(buf, str(tmp_path / "ds.zarr"))
    dms = []
    for mod in (jds, tds):
        dm = mod.DataModule(batch_size=16, data_dir=str(tmp_path), T_obs=OBS,
                            T_pred=PRED, seed=42, step_size=STEP)
        dm.setup("ds.zarr")
        dms.append(dm)
    jdm, tdm = dms
    np.testing.assert_array_equal(tdm.train_idx, jdm.train_idx)
    np.testing.assert_array_equal(tdm.val_idx, jdm.val_idx)
    _stats_equal(tdm.stats, jdm.stats)
    got = list(tdm.train_batches(rng=np.random.default_rng(42)))
    want = list(jdm.train_batches(rng=np.random.default_rng(42)))
    assert len(got) == len(want) == len(jdm.train_idx) // 16
    for g, w in zip(got + list(tdm.val_batches()),
                    want + list(jdm.val_batches())):
        for k in w:
            _ulp_close(g[k], w[k])


@pytest.mark.parametrize("zip_it", [False, True])
def test_port_zarr_read_by_jax(tmp_path, zip_it):
    """The port's save_zarr (zlib by default, chunked as the JAX package
    chunks) read by the JAX package's tensorstore loader, also as a .zip."""
    buf = _synthetic(np.random.default_rng(5))
    path = str(tmp_path / "p.zarr")
    buf.save_to_path(path, chunk_length=64, make_zip=zip_it)
    got = jr.load_zarr(path + ".zip" if zip_it else path)
    np.testing.assert_array_equal(got.episode_ends, buf.episode_ends)
    for k, v in buf.data.items():
        assert got.data[k].dtype == v.dtype
        np.testing.assert_array_equal(got.data[k], v)
    np.testing.assert_array_equal(got.meta["track_seed"],
                                  buf.meta["track_seed"])
    back = tr.load_zarr(path + ".zip" if zip_it else path)
    for k, v in buf.data.items():
        np.testing.assert_array_equal(back.data[k], v)


def test_jax_zarr_with_null_and_zlib_read_by_port(tmp_path):
    """The JAX package's save_zarr with a per-key compressor dict of null
    and zlib, read by the port."""
    buf = _synthetic(np.random.default_rng(6))
    jbuf = jr.ReplayBuffer(data=dict(buf.data),
                           episode_ends=buf.episode_ends.copy(),
                           meta=dict(buf.meta))
    zl = {"id": "zlib", "level": 1}
    path = str(tmp_path / "j.zarr")
    jr.save_zarr(jbuf, path, chunk_length=50, compressors={
        "img": zl, "position": None, "velocity": zl, "action": None,
        "episode_ends": None, "track_seed": zl})
    got = tr.load_zarr(path)
    np.testing.assert_array_equal(got.episode_ends, buf.episode_ends)
    for k, v in buf.data.items():
        assert got.data[k].dtype == v.dtype
        np.testing.assert_array_equal(got.data[k], v)
    np.testing.assert_array_equal(got.meta["track_seed"],
                                  buf.meta["track_seed"])


def test_port_refuses_a_blosc_store(monkeypatch):
    """Where the zstandard package does not import (the GPU machine), the
    port reads the blosc-zstd store all the same, through its own zstd
    decoder: the first episode's arrays equal tensorstore's. A blosc codec
    it does not read (blosclz) is refused, named."""
    import builtins

    real = builtins.__import__

    def no_zstandard(name, *args, **kw):
        if name == "zstandard":
            raise ModuleNotFoundError("No module named 'zstandard'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_zstandard)
    data, ends = _read_store(1)
    store = tr._DirStore(STORE)
    for k in KEYS:
        got = tr._read_array(store, f"data/{k}", (0, int(ends[-1])))
        np.testing.assert_array_equal(got, data[k])
    with pytest.raises(ValueError, match="blosclz"):
        tr._check_codec({"id": "blosc", "cname": "blosclz"}, "x")


def test_replay_buffer_episode_api():
    buf = _synthetic(np.random.default_rng(7), lengths=(5, 7))
    assert (buf.n_episodes, buf.n_steps) == (2, 12)
    ep = buf.get_episode(1)
    np.testing.assert_array_equal(ep["action"], buf.data["action"][5:])
    popped = buf.pop_episode()
    np.testing.assert_array_equal(popped["img"], ep["img"])
    assert (buf.n_episodes, buf.n_steps) == (1, 5)
    with pytest.raises(ValueError, match="disagree"):
        buf.add_episode({"img": np.zeros((3, 8, 8, 3), np.uint8),
                         "position": np.zeros((2, 2), np.float32)})


def test_stats_pickle_both_ways(tmp_path, two_episodes):
    _, _, jw, tw = two_episodes
    tds.save_stats(tw.stats, str(tmp_path / "port.pkl"))
    jw.save_stats(str(tmp_path / "jax.pkl"))
    _stats_equal(jds.load_stats(str(tmp_path / "port.pkl")), jw.stats)
    _stats_equal(tds.load_stats(str(tmp_path / "jax.pkl")), tw.stats)
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw, list) and len(raw) == 1
    assert os.path.getsize(tmp_path / "port.pkl") > 0
