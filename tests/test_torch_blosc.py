"""The port's blosc reader (`data/replay_buffer.py::_blosc_decode`) against
the JAX package's tensorstore, on CPU.

- The committed shared eval store (blosc zstd-5 with bitshuffle: typesize
  8 for the int64 meta arrays, 4 for the float32 data) read by the port
  equals what tensorstore reads, exactly: every key but `img` whole, and
  the first, a middle and the last chunk of `img` (its 12,000 float32
  frames are 1.33 GB; the whole of it is a `slow` test, against the JAX
  package's `load_zarr`).
- Stores written by the JAX package's `save_zarr` (tensorstore) with blosc
  zstd, lz4, lz4hc, zlib, blosclz and snappy (every codec tensorstore
  writes), each with shuffle 0, 1 and 2 and with clevel 0 (memcpyed
  chunks) and 5, read back exactly, with lengths that leave a partial
  chunk, a leftover block and blocks whose element count is not a
  multiple of 8 (bitshuffle stores those as they are).
- The blosclz and snappy decoders refuse truncated streams, streams of
  another size, and bytes mutated at random (an error or a wrong output,
  never a read or write past a buffer).
- Without the zstandard package a zstd store is read all the same (the
  port's own zstd decoder); a gzip store is read; a compressor neither
  package reads (id lz4, in a hand-written `.zarray`) raises naming it;
  an lz4 store is read through the port's own decoder.
"""

import builtins
import pathlib

import numpy as np
import pytest
import tensorstore as ts

from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch.data import native
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
@pytest.mark.parametrize("cname", ["zstd", "lz4", "lz4hc", "zlib", "blosclz",
                                   "snappy"])
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


@pytest.mark.parametrize("cname", ["blosclz", "snappy"])
def test_blosclz_and_snappy_refuse_malformed_streams(tmp_path, cname):
    # float32 without shuffle, one block split into 4 streams: the first
    # stream holds the block's first quarter of bytes
    data = (b"the lazy dog jumps over the quick brown fox; " * 900
            + bytes(range(256)) * 20)
    buf = jrb.ReplayBuffer.create_empty_numpy()
    buf.add_episode({"f": np.frombuffer(data, np.float32)})
    jrb.save_zarr(buf, str(tmp_path / "s.zarr"), compressors={k: {
        "id": "blosc", "cname": cname, "clevel": 5, "shuffle": 0}
        for k in ("f", "episode_ends")})
    blob = (tmp_path / "s.zarr" / "data" / "f" / "0").read_bytes()
    nbytes, blocksize = (int(v) for v in np.frombuffer(blob, "<u4", 2, 4))
    assert (blob[2], nbytes, blocksize) == (
        0 if cname == "blosclz" else 0x40, len(data), len(data))
    size = int(np.frombuffer(blob, "<i4", 1, 20)[0])
    stream, data = blob[24:24 + size], data[:len(data) // 4]
    assert size < len(data)
    decode = getattr(native, f"{cname}_decompress")
    assert decode(stream, len(data)) == data
    for n in (1, 2, len(stream) // 2, len(stream) - 1):
        with pytest.raises(ValueError):
            decode(stream[:n], len(data))
    with pytest.raises(ValueError):
        decode(stream, len(data) - 1)
    # mutated streams: the library's decoder returns -1 or a size within
    # the output, and writes nothing past it (a guard of 64 bytes behind
    # the output keeps its fill); the wrapper raises or returns exactly
    # len(data) bytes. Reads past the input are not visible here.
    raw = getattr(native.codec_library(), f"{cname}_decompress")
    rng = np.random.default_rng(0)
    for _ in range(3000):
        bad = bytearray(stream)
        for i in rng.integers(0, len(bad), rng.integers(1, 4)):
            bad[i] = rng.integers(0, 256)
        src = np.frombuffer(bytes(bad), np.uint8)
        out = np.full(len(data) + 64, 0xA5, np.uint8)
        n = raw(src.ctypes.data, src.size, out.ctypes.data, len(data))
        assert n == -1 or 0 <= n <= len(data), n
        assert (out[len(data):] == 0xA5).all()
        try:
            assert len(decode(bytes(bad), len(data))) == len(data)
        except ValueError:
            pass


def _block_zstandard(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "zstandard":
            raise ModuleNotFoundError("No module named 'zstandard'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_missing_codecs_are_named(tmp_path, monkeypatch):
    buf = _buffer(100, seed=1)
    keys = [*buf.data, "episode_ends", *buf.meta]
    for cname in ("zstd", "lz4"):
        jrb.save_zarr(buf, str(tmp_path / f"{cname}.zarr"), compressors={
            k: {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": 2}
            for k in keys})
    jrb.save_zarr(buf, str(tmp_path / "gzip.zarr"), compressors={
        k: {"id": "gzip", "level": 5} for k in keys})
    # gzip is read (since the port reads every compressor tensorstore
    # takes); a compressor tensorstore does not register, in a .zarray
    # written by hand, is refused by both, named
    got = trb.load_zarr(str(tmp_path / "gzip.zarr"))
    for k, v in buf.data.items():
        assert np.array_equal(got.data[k], v), k
    zarray = tmp_path / "gzip.zarr" / "data" / "img" / ".zarray"
    zarray.write_text(zarray.read_text().replace('"gzip"', '"lz4"'))
    with pytest.raises(ValueError, match="lz4"):
        trb.load_zarr(str(tmp_path / "gzip.zarr"))
    with pytest.raises(ValueError, match="lz4"):
        jrb.load_zarr(str(tmp_path / "gzip.zarr"))
    # zstd needs nothing but the port's host library either
    _block_zstandard(monkeypatch)
    got = trb.load_zarr(str(tmp_path / "zstd.zarr"))
    for k, v in buf.data.items():
        assert np.array_equal(got.data[k], v), k
    # lz4 needs nothing but the port's host library
    got = trb.load_zarr(str(tmp_path / "lz4.zarr"))
    assert np.array_equal(got.data["position"], buf.data["position"])
    # zlib, gzip and uncompressed stores name nothing
    trb._zarray_compressor({"id": "zlib", "level": 1}, "x")
    trb._zarray_compressor({"id": "gzip"}, "x")
    trb._zarray_compressor(None, "x")
    with pytest.raises(ValueError, match="lz4"):
        trb._zarray_compressor({"id": "lz4"}, "x")


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
