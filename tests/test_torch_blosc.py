"""The port's blosc reader (`data/replay_buffer.py::_blosc_decode`) against
the JAX package's tensorstore, on CPU.

- The committed shared eval store (blosc zstd-5 with bitshuffle: typesize
  8 for the int64 meta arrays, 4 for the float32 data) read by the port
  equals what tensorstore reads, exactly: every key but `img` whole, and
  the first, a middle and the last chunk of `img` (its 12,000 float32
  frames are 1.33 GB; the whole of it is a `slow` test, against the JAX
  package's `load_zarr`).
- Stores written by the JAX package's `save_zarr` (tensorstore) with blosc
  zstd, lz4, lz4hc and zlib, each with shuffle 0, 1 and 2 and with clevel
  0 (memcpyed chunks) and 5, read back exactly, with lengths that leave a
  partial chunk, a leftover block and blocks whose element count is not a
  multiple of 8 (bitshuffle stores those as they are).
- Without the zstandard package a zstd store is read all the same (the
  port's own zstd decoder); blosclz raises naming it; an lz4 store is read
  through the port's own decoder.
"""

import builtins
import pathlib

import numpy as np
import pytest
import tensorstore as ts

from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch.data import replay_buffer as trb

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED = REPO / "data" / "eval_shared" / \
    "shared_eval_dataset_6_episodes_3_drivers.zarr"
KEYS = ["data/action", "data/angle", "data/car_state", "data/position",
        "data/velocity", "meta/driver_id", "meta/episode_ends",
        "meta/track_seed"]


def _ts_read(root, key, rows=None):
    arr = ts.open(jrb._ts_spec(str(root), key)).result()
    return (arr if rows is None else arr[rows[0]:rows[1]]).read().result()


def test_shared_eval_store_equals_tensorstore():
    store = trb._DirStore(str(SHARED))
    for key in KEYS:
        meta = trb._array_meta(store, key)
        assert meta["compressor"]["cname"] == "zstd"
        assert meta["compressor"]["shuffle"] == 2
        got, want = trb._read_array(store, key), _ts_read(SHARED, key)
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    n = trb._array_meta(store, "data/img")["shape"][0]
    for rows in ((0, 18), (5994, 6030), (n - 12, n)):
        got = trb._read_array(store, "data/img", rows)
        want = _ts_read(SHARED, "data/img", rows)
        assert got.shape == (rows[1] - rows[0], 96, 96, 3)
        assert np.array_equal(got, want), rows


@pytest.mark.slow
def test_shared_eval_store_whole_equals_jax_load_zarr():
    got, want = trb.load_zarr(str(SHARED)), jrb.load_zarr(str(SHARED))
    assert set(got.data) == set(want.data)
    for k in want.data:
        assert np.array_equal(got.data[k], np.asarray(want.data[k])), k
    assert np.array_equal(got.episode_ends, want.episode_ends)
    assert set(got.meta) == set(want.meta)
    for k in want.meta:
        assert np.array_equal(got.meta[k], np.asarray(want.meta[k])), k


def _buffer(n, seed):
    rng = np.random.default_rng(seed)
    buf = jrb.ReplayBuffer.create_empty_numpy()
    buf.add_episode({
        "img": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
        "position": np.cumsum(rng.normal(size=(n, 2)), 0).astype(np.float32),
        "action": np.round(rng.normal(size=(n, 3)), 2).astype(np.float32),
        "step": np.arange(n, dtype=np.int64) * 3,
        "noise": rng.normal(size=(n,))})
    buf.meta["track_seed"] = np.array([42], np.int64)
    return buf


@pytest.mark.parametrize("clevel", [0, 5])
@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", ["zstd", "lz4", "lz4hc", "zlib"])
def test_jax_blosc_stores_read_back_exactly(tmp_path, cname, shuffle,
                                            clevel):
    # 70,001 rows in chunks of 33,333: a partial last chunk; blocks of the
    # 8-byte arrays hold element counts that are not multiples of 8
    buf = _buffer(70001, seed=shuffle + 3 * clevel)
    comp = {"id": "blosc", "cname": cname, "clevel": clevel,
            "shuffle": shuffle}
    path = str(tmp_path / "s.zarr")
    jrb.save_zarr(buf, path, chunk_length=33333, compressors={
        k: comp for k in [*buf.data, "episode_ends", *buf.meta]})
    got = trb.load_zarr(path)
    for k, v in buf.data.items():
        assert got.data[k].dtype == v.dtype
        assert np.array_equal(got.data[k], v), k
    assert np.array_equal(got.episode_ends, buf.episode_ends)
    assert np.array_equal(got.meta["track_seed"], buf.meta["track_seed"])


def _block_zstandard(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "zstandard":
            raise ModuleNotFoundError("No module named 'zstandard'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_missing_codecs_are_named(tmp_path, monkeypatch):
    buf = _buffer(100, seed=1)
    for cname in ("zstd", "lz4", "blosclz"):
        jrb.save_zarr(buf, str(tmp_path / f"{cname}.zarr"), compressors={
            k: {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": 2}
            for k in [*buf.data, "episode_ends", *buf.meta]})
    with pytest.raises(ValueError, match="blosclz"):
        trb.load_zarr(str(tmp_path / "blosclz.zarr"))
    # zstd needs nothing but the port's host library either
    _block_zstandard(monkeypatch)
    got = trb.load_zarr(str(tmp_path / "zstd.zarr"))
    for k, v in buf.data.items():
        assert np.array_equal(got.data[k], v), k
    # lz4 needs nothing but the port's host library
    got = trb.load_zarr(str(tmp_path / "lz4.zarr"))
    assert np.array_equal(got.data["position"], buf.data["position"])
    # zlib and uncompressed stores name nothing
    trb._check_codec({"id": "zlib", "level": 1}, "x")
    trb._check_codec(None, "x")
    with pytest.raises(ValueError, match="gzip"):
        trb._check_codec({"id": "gzip"}, "x")


def test_shared_store_windows_read_through_the_dataset():
    """The port's WindowDataset over a blosc store's arrays, as the eval
    sweep reads them: here the first 300 frames, read by rows."""
    store = trb._DirStore(str(SHARED))
    n = 300
    data = {k: trb._read_array(store, f"data/{k}", (0, n))
            for k in ("position", "velocity", "action", "img")}
    from state_policy_diffusionmodel_torch.data.dataset import WindowDataset

    ds = WindowDataset((data, np.array([n])), 10, 30, 5)
    batch = ds.batch(np.arange(4))
    assert batch["image"].shape == (4, 40, 96, 96, 3)
    assert all(np.isfinite(v).all() for v in batch.values())
