"""Every zarr v2 compressor the JAX package's store takes, in the port
(`data/replay_buffer.py::ZARR_COMPRESSORS`; the blosclz and snappy
encoders and c-blosc's forced block size in `csrc/blosc_codec.cpp`),
against the JAX package's tensorstore store, on CPU. Every direction goes
through the JAX package's own `save_zarr`, `ZarrReplayBuffer` and
`load_zarr`.

- Round trips: each spec below (gzip, bz2 and zstd at their bounds and
  defaults, zlib, blosc with every cname, shuffle -1 to 2 and forced block
  sizes, no compressor), on arrays of typesize 1, 4 and 8 holding zeros,
  runs and random bytes, each with a partial last chunk: what the JAX
  package writes the port reads equal, bit for bit, and what the port
  writes the JAX package reads equal; both `.zarray`s state the same
  compressor, the normalized defaults included.
- Blosc headers: every chunk's flags, typesize and block size equal
  tensorstore's for the same array and spec (blocksize 0, 100, 4096 and
  65,536; shuffle -1 to 2; every cname) on zeros, runs and random bytes.
  Where the data lets a codec shrink a stream a little, whether c-blosc
  keeps the chunk compressed depends on its codecs' own heuristics; on
  these data the outcome is the same for any encoder.
- F-order arrays written by tensorstore are read by the port and appended
  to by both packages' live stores.
- The live stores append to each other's gzip, bz2, zstd, blosclz and
  snappy stores, a chunk straddling each two episodes.
- The blosclz and snappy encoders: a hypothesis property through the
  port's decoders, and the 12 `img` chunks of `data/eval_shared` written as
  each, read back by tensorstore and held within 1.25x c-blosc's bytes
  (the printed ratio).
- Specs tensorstore refuses are refused by both packages, the port's
  before any file of the store exists; a `.zarray` naming one is refused
  on read by both.
- Without Python's bz2 a bz2 store is neither written nor read, and the
  error names bz2.
"""

import builtins
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import tensorstore as ts
from hypothesis import given, settings
from hypothesis import strategies as st

from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch.data import native
from state_policy_diffusionmodel_torch.data import replay_buffer as trb

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED_IMG = REPO / "data" / "eval_shared" / \
    "shared_eval_dataset_6_episodes_3_drivers.zarr" / "data" / "img"

SPECS = [
    None,
    {"id": "zlib"}, {"id": "zlib", "level": 9},
    {"id": "gzip"}, {"id": "gzip", "level": 0}, {"id": "gzip", "level": 9},
    {"id": "bz2"}, {"id": "bz2", "level": 9},
    {"id": "zstd"}, {"id": "zstd", "level": -131072},
    {"id": "zstd", "level": -7}, {"id": "zstd", "level": 0},
    {"id": "zstd", "level": 10}, {"id": "zstd", "level": 22},
    {"id": "blosc"},
    {"id": "blosc", "cname": "blosclz", "clevel": 5, "shuffle": 1},
    {"id": "blosc", "cname": "blosclz", "clevel": 9, "shuffle": -1,
     "blocksize": 4096},
    {"id": "blosc", "cname": "blosclz", "clevel": 0, "shuffle": 2},
    {"id": "blosc", "cname": "snappy", "clevel": 5, "shuffle": 1},
    {"id": "blosc", "cname": "snappy", "clevel": 1, "shuffle": 2,
     "blocksize": 100},
    {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": -1,
     "blocksize": 65536},
    {"id": "blosc", "cname": "lz4hc", "clevel": 9, "shuffle": 0,
     "blocksize": 100},
    {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": -1},
    {"id": "blosc", "cname": "zlib", "clevel": 1, "shuffle": -1,
     "blocksize": 4096},
]
SPEC_IDS = ["none" if s is None else "-".join(str(v) for v in s.values())
            for s in SPECS]
DTYPES = ("<u1", "<f4", "<i8")     # typesize 1, 4 and 8


def _column(kind, n, dtype, rng):
    """n rows of 16 values: zeros, runs of one value, or random bytes."""
    dtype = np.dtype(dtype)
    if kind == "zeros":
        return np.zeros((n, 16), dtype)
    if kind == "runs":
        vals = rng.integers(0, 9, n * 16 // 5 + 1)
        lens = rng.integers(1, 60, vals.size)
        return np.repeat(vals, lens)[:n * 16].reshape(n, 16).astype(dtype)
    return rng.integers(0, 256, n * 16 * dtype.itemsize,
                        dtype=np.uint8).view(dtype).reshape(n, 16)


def _buffer(n, seed, kinds=("zeros", "runs", "random")):
    rng = np.random.default_rng(seed)
    buf = trb.ReplayBuffer()
    buf.add_episode({f"{kind}_{np.dtype(dt).itemsize}":
                     _column(kind, n, dt, rng)
                     for kind in kinds for dt in DTYPES})
    buf.meta["track_seed"] = np.array([7], np.int64)
    return buf


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _assert_equal(got, buf):
    assert sorted(got.data) == sorted(buf.data)
    for k, v in buf.data.items():
        assert _equal(got.data[k], v), k
    assert _equal(got.episode_ends, buf.episode_ends)
    assert sorted(got.meta) == sorted(buf.meta)
    for k, v in buf.meta.items():
        assert _equal(got.meta[k], v), k


def _zarrays(path):
    out = {}
    for group in ("data", "meta"):
        for k in sorted(os.listdir(os.path.join(path, group))):
            if not k.startswith("."):
                with open(os.path.join(path, group, k, ".zarray")) as f:
                    out[f"{group}/{k}"] = json.load(f)
    return out


def _every_key(buf, spec):
    return {k: spec for k in [*buf.data, "episode_ends", *buf.meta]}


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_jax_writes_port_reads(tmp_path, spec):
    buf = _buffer(2500, seed=len(SPEC_IDS[SPECS.index(spec)]))
    path = str(tmp_path / "jax.zarr")
    jrb.save_zarr(buf, path, chunk_length=1100,
                  compressors=_every_key(buf, spec))
    _assert_equal(trb.load_zarr(path), buf)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_port_writes_jax_reads(tmp_path, spec):
    buf = _buffer(2500, seed=len(SPEC_IDS[SPECS.index(spec)]) + 1)
    comps = _every_key(buf, spec)
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, chunk_length=1100, compressors=comps)
    _assert_equal(jrb.load_zarr(path), buf)
    _assert_equal(trb.load_zarr(path), buf)
    jrb.save_zarr(buf, ref, chunk_length=1100, compressors=comps)
    got, want = _zarrays(path), _zarrays(ref)
    assert {k: m["compressor"] for k, m in got.items()} == \
        {k: m["compressor"] for k, m in want.items()}
    assert {k: m["order"] for k, m in got.items()} == \
        {k: "C" for k in want}


def _chunk_headers(path):
    """(flags, typesize, block size) of every chunk of every data array."""
    out = {}
    for k in sorted(os.listdir(os.path.join(path, "data"))):
        if k.startswith("."):
            continue
        for name in sorted(os.listdir(os.path.join(path, "data", k))):
            if not name.startswith("."):
                blob = (pathlib.Path(path) / "data" / k / name).read_bytes()
                out[f"{k}/{name}"] = (blob[2], blob[3], int.from_bytes(
                    blob[8:12], "little"))
    return out


@pytest.mark.parametrize("blocksize", [0, 100, 4096, 65536])
@pytest.mark.parametrize("cname", native.BLOSC_CNAMES)
def test_blosc_headers_equal_tensorstores(tmp_path, cname, blocksize):
    rng = np.random.default_rng(blocksize + len(cname))
    buf, comps = trb.ReplayBuffer(), {}
    episode = {}
    for shuffle in (-1, 0, 1, 2):
        for kind in ("zeros", "runs", "random"):
            for dt in DTYPES:
                key = f"{kind}_{np.dtype(dt).itemsize}_s{shuffle}"
                episode[key] = _column(kind, 1500, dt, rng)
                comps[key] = {"id": "blosc", "cname": cname, "clevel": 5,
                              "shuffle": shuffle, "blocksize": blocksize}
    buf.add_episode(episode)
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, chunk_length=700, compressors=comps)
    jrb.save_zarr(buf, ref, chunk_length=700, compressors=comps)
    got, want = _chunk_headers(path), _chunk_headers(ref)
    assert len(got) == 36 * 3
    assert got == want
    # snappy at blocksize 100: 128-byte blocks, not split, for 8-byte
    # elements; c-blosc's split floor of 65,536 bytes, capped at the
    # 11,200-byte chunk, for 1-byte ones, which makes the chunk one stream
    # and so stored whole (c-blosc gives snappy its bound or no room)
    if cname == "snappy" and blocksize == 100:
        assert got["runs_8_s1/0.0"] == (0x51, 8, 128)
        assert got["runs_1_s1/0.0"] == (0x43, 1, 11200)
    _assert_equal(jrb.load_zarr(path), buf)


@pytest.mark.parametrize("clevel", [1, 5, 9])
@pytest.mark.parametrize("cname", native.BLOSC_CNAMES)
def test_blosc_block_sizes_equal_tensorstores(tmp_path, cname, clevel):
    """c-blosc's own block size of a 1,000,000-byte chunk of float32 runs
    (lz4hc, zlib and zstd take doubled blocks; each clevel its factor)."""
    rng = np.random.default_rng(clevel)
    buf = trb.ReplayBuffer()
    buf.add_episode({"x": _column("runs", 15625, "<f4", rng)})
    comps = {"x": {"id": "blosc", "cname": cname, "clevel": clevel,
                   "shuffle": 1}}
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, compressors=comps)
    jrb.save_zarr(buf, ref, compressors=comps)
    assert _chunk_headers(path) == _chunk_headers(ref)
    _assert_equal(jrb.load_zarr(path), buf)


@pytest.mark.parametrize("blocksize", [2 ** 31 - 1, 2 ** 31, 2 ** 32 + 4096,
                                       2 ** 40, 2 ** 64 - 1])
def test_blosc_blocksize_as_cblosc_takes_it(tmp_path, blocksize):
    """tensorstore takes any blocksize below 2**64 and c-blosc reads it as
    a 32-bit int: the port's chunks have the same block size and flags."""
    rng = np.random.default_rng(3)
    buf = trb.ReplayBuffer()
    buf.add_episode({"x": _column("runs", 15625, "<f4", rng)})
    comps = {"x": {"id": "blosc", "cname": "lz4", "clevel": 5,
                   "shuffle": 1, "blocksize": blocksize}}
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, compressors=comps)
    jrb.save_zarr(buf, ref, compressors=comps)
    assert _chunk_headers(path) == _chunk_headers(ref)
    assert _zarrays(path)["data/x"]["compressor"]["blocksize"] == blocksize
    _assert_equal(jrb.load_zarr(path), buf)


@pytest.mark.parametrize("dtype,flags,block", [("|u1", 0x41, 65536),
                                                ("<f8", 0x51, 128)])
def test_probed_snappy_blocksize_100_headers(tmp_path, dtype, flags, block):
    """blosc snappy-5, byte shuffle, blocksize 100 on 300,000 elements:
    c-blosc raises the block to 128 bytes, which for 8-byte elements stays
    unsplit (0x10) and for bytes is split and so raised to 65,536."""
    buf = trb.ReplayBuffer()
    buf.add_episode({"x": (np.arange(300000) % 7).astype(dtype)})
    comps = {"x": {"id": "blosc", "cname": "snappy", "clevel": 5,
                   "shuffle": 1, "blocksize": 100}}
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, compressors=comps)
    jrb.save_zarr(buf, ref, compressors=comps)
    got = _chunk_headers(path)
    assert got == _chunk_headers(ref)
    assert got["x/0"] == (flags, np.dtype(dtype).itemsize, block)
    _assert_equal(jrb.load_zarr(path), buf)


def _f_order_store(path, spec, eps):
    """A store as tensorstore writes it with order F: data/img (n, 6, 5)
    uint8, data/action (n, 3) float32, data/step (n,) int64, chunks of 4
    rows, meta/episode_ends uncompressed."""
    jrb._write_group_meta(path)
    full = {k: np.concatenate([ep[k] for ep in eps]) for k in eps[0]}
    for k, v in full.items():
        spec_k = jrb._ts_spec(path, f"data/{k}")
        spec_k["metadata"] = {"shape": list(v.shape),
                              "chunks": [4] + list(v.shape[1:]),
                              "dtype": v.dtype.str, "compressor": spec,
                              "order": "F" if v.ndim > 1 else "C"}
        store = ts.open(spec_k, create=True, delete_existing=True).result()
        store[...] = v
    ends = np.cumsum([len(ep["step"]) for ep in eps]).astype(np.int64)
    spec_e = jrb._ts_spec(path, "meta/episode_ends")
    spec_e["metadata"] = {"shape": [len(ends)], "chunks": [len(ends)],
                          "dtype": "<i8", "compressor": None}
    ts.open(spec_e, create=True, delete_existing=True).result()[...] = ends


def _episodes(seed, lengths):
    rng = np.random.default_rng(seed)
    return [{"img": rng.integers(0, 256, (n, 6, 5), dtype=np.uint8),
             "action": rng.normal(size=(n, 3)).astype(np.float32),
             "step": np.arange(n, dtype=np.int64) * 7} for n in lengths]


def _reference(eps):
    ref = trb.ReplayBuffer()
    for ep in eps:
        ref.add_episode(ep)
    return ref


@pytest.mark.parametrize("spec", [
    {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": -1,
     "blocksize": 0},
    {"id": "zstd", "level": 3}, {"id": "gzip", "level": 1}, None],
    ids=["blosc", "zstd", "gzip", "none"])
def test_f_order_arrays_read_and_appended(tmp_path, spec):
    eps = _episodes(5, (7, 6, 5, 9))
    path = str(tmp_path / "f.zarr")
    _f_order_store(path, spec, eps[:2])
    for k in ("img", "action"):
        assert _zarrays(path)[f"data/{k}"]["order"] == "F"
    _assert_equal(trb.load_zarr(path), _reference(eps[:2]))
    # the port appends (chunk 3 straddles), then the JAX package
    trb.ZarrReplayBuffer(path).add_episode(eps[2])
    for mod in (jrb, trb):
        _assert_equal(mod.load_zarr(path), _reference(eps[:3]))
    assert _zarrays(path)["data/img"]["order"] == "F"
    jrb.ZarrReplayBuffer(path).add_episode(eps[3])
    z = trb.ZarrReplayBuffer(path)
    assert _equal(z.get_episode(3)["img"], eps[3]["img"])
    _assert_equal(trb.load_zarr(path), _reference(eps))


APPEND_SPECS = [
    {"id": "gzip", "level": 5}, {"id": "bz2", "level": 1},
    {"id": "zstd", "level": 3},
    {"id": "blosc", "cname": "blosclz", "clevel": 5, "shuffle": 1,
     "blocksize": 0},
    {"id": "blosc", "cname": "snappy", "clevel": 5, "shuffle": 1,
     "blocksize": 0}]


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("spec", APPEND_SPECS,
                         ids=["gzip", "bz2", "zstd", "blosclz", "snappy"])
def test_live_stores_append_across_packages(tmp_path, spec, first):
    """One package creates the store with two episodes (chunks of 4 rows,
    so each next episode straddles a chunk), then the two append in turn;
    after each append both load_zarr read every episode so far."""
    eps = _episodes(9, (7, 6, 5, 9, 3))
    path = str(tmp_path / "live.zarr")
    mods = [jrb, trb] if first == "jax" else [trb, jrb]
    z = mods[0].ZarrReplayBuffer(path, compressors={
        k: spec for k in eps[0]}, chunk_length=4)
    for ep in eps[:2]:
        z.add_episode(ep)
    for i in range(2, len(eps)):
        mods[(i + 1) % 2].ZarrReplayBuffer(path).add_episode(eps[i])
        for mod in (jrb, trb):
            _assert_equal(mod.load_zarr(path), _reference(eps[:i + 1]))
    assert {k: m["compressor"] for k, m in _zarrays(path).items()
            if k.startswith("data/")} == {
        f"data/{k}": trb._zarray_compressor(spec) for k in eps[0]}


@settings(max_examples=80, deadline=None)
@given(st.one_of(
    st.binary(min_size=0, max_size=4000),
    st.builds(lambda chunk, n: chunk * n,
              st.binary(min_size=1, max_size=40), st.integers(1, 600)),
    st.builds(lambda a, b, gap: a + bytes(gap) + a + b,
              st.binary(min_size=8, max_size=64), st.binary(max_size=64),
              st.integers(8000, 70000))),
    st.sampled_from([1, 5, 9]))
def test_property_blosclz_and_snappy_encoders(data, clevel):
    """Random, repetitive and far-repeating bytes (the last reach
    blosclz's 16-bit far distances) through each encoder and the port's
    decoders; a blosclz stream ends in literals."""
    lz = native.blosclz_compress(data, clevel)
    assert native.blosclz_decompress(lz, len(data)) == data
    if data:
        assert lz[0] >> 5 == 1              # the format's level
        assert len(lz) <= len(data) + len(data) // 32 + 1
    sn = native.snappy_compress(data, clevel)
    assert native.snappy_decompress(sn, len(data)) == data
    assert len(sn) <= 32 + len(data) + len(data) // 6


@pytest.mark.parametrize("shuffle", [1, 2])
@pytest.mark.parametrize("cname", ["blosclz", "snappy"])
def test_shared_img_chunks_written_as_blosclz_and_snappy(tmp_path, cname,
                                                         shuffle):
    """The 12 `img` chunks of the committed shared store, as the port
    writes them with blosc blosclz or snappy (byte shuffle or bitshuffle,
    typesize 4), read back by tensorstore."""
    meta = json.loads((SHARED_IMG / ".zarray").read_text())
    rows = meta["chunks"][0]
    img = np.concatenate([
        np.frombuffer(trb._blosc_decode((SHARED_IMG / f"{i}.0.0.0")
                                        .read_bytes()), "<f4")
        .reshape([rows] + meta["chunks"][1:]) for i in range(0, 661, 60)])
    spec = {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle,
            "blocksize": 0}
    path, ref = str(tmp_path / "img"), str(tmp_path / "ref")
    trb._write_array(path, img, rows, spec)
    back = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": path}}).result().read().result()
    assert _equal(back, img)
    theirs = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": ref}, "metadata": {
        "shape": list(img.shape), "chunks": [rows] + list(img.shape[1:]),
        "dtype": "<f4", "compressor": spec}}, create=True).result()
    theirs[...] = img
    disk, cblosc = (sum(os.path.getsize(os.path.join(d, f"{i}.0.0.0"))
                        for i in range(12)) for d in (path, ref))
    print(f"12 img chunks ({img.nbytes} bytes) as blosc {cname}-5, "
          f"shuffle {shuffle}: {disk} bytes, {disk / cblosc:.4f}x c-blosc's "
          f"{cblosc}")
    assert disk <= 1.25 * cblosc


REFUSED = [
    ({"id": "lz4"}, "lz4"),
    ({"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 3}, "shuffle"),
    ({"id": "blosc", "cname": "zstd", "clevel": 10, "shuffle": 1}, "clevel"),
    ({"id": "blosc", "cname": "zstd", "blocksize": -1}, "blocksize"),
    ({"id": "blosc", "cname": "ndlz"}, "ndlz"),
    ({"id": "gzip", "level": -1}, "gzip level"),
    ({"id": "bz2", "level": 0}, "bz2 level"),
    ({"id": "zstd", "level": 23}, "zstd level"),
    ({"id": "zlib", "level": 1, "filters": [{"id": "delta",
                                             "dtype": "<f8"}]}, "filters"),
    ({"id": "gzip", "level": "3"}, "gzip level"),
]


@pytest.mark.parametrize("spec,named", REFUSED, ids=[
    "lz4", "shuffle_3", "clevel_10", "blocksize_-1", "ndlz", "gzip_-1",
    "bz2_0", "zstd_23", "filters", "gzip_str"])
def test_specs_tensorstore_refuses_are_refused(tmp_path, spec, named):
    buf = _buffer(300, seed=2, kinds=("runs",))
    comps = {"runs_1": spec}
    with pytest.raises(ValueError):
        jrb.save_zarr(buf, str(tmp_path / "jax.zarr"), compressors=comps)
    path = str(tmp_path / "port.zarr")
    with pytest.raises(ValueError, match=named):
        buf.save_to_path(path, compressors=comps)
    assert not os.path.exists(path)
    live = str(tmp_path / "live.zarr")
    with pytest.raises(ValueError, match=named):
        trb.ZarrReplayBuffer(live, compressors=comps).add_episode(
            buf.get_episode(0))
    assert [k for k in os.listdir(os.path.join(live, "data"))
            if not k.startswith(".")] == []


@pytest.mark.parametrize("edit", ["lz4", "filters"])
def test_refused_zarray_is_refused_on_read(tmp_path, edit):
    """A `.zarray` naming a compressor tensorstore does not register, or
    filters, is refused by both packages' load_zarr, named."""
    buf = _buffer(300, seed=3, kinds=("runs",))
    path = str(tmp_path / "s.zarr")
    buf.save_to_path(path, compressors="default")
    zarray = os.path.join(path, "data", "runs_4", ".zarray")
    with open(zarray) as f:
        meta = json.load(f)
    if edit == "lz4":
        meta["compressor"] = {"id": "lz4", "acceleration": 1}
    else:
        meta["filters"] = [{"id": "delta", "dtype": "<f4"}]
    with open(zarray, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError):
        jrb.load_zarr(path)
    with pytest.raises(ValueError, match=edit):
        trb.load_zarr(path)


def _block_bz2(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "bz2":
            raise ModuleNotFoundError("No module named '_bz2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_no_bz2_no_fallback(tmp_path, monkeypatch):
    """Without Python's bz2 a bz2 store raises ImportError naming bz2: a
    write leaves no file of the store, a read returns nothing."""
    buf = _buffer(300, seed=4, kinds=("runs",))
    written = str(tmp_path / "written.zarr")
    buf.save_to_path(written, compressors={"runs_8": {"id": "bz2"}})
    _block_bz2(monkeypatch)
    path = str(tmp_path / "bz2.zarr")
    with pytest.raises(ImportError, match="bz2"):
        buf.save_to_path(path, compressors={"runs_8": {"id": "bz2"}})
    assert not os.path.exists(path)
    with pytest.raises(ImportError, match="bz2"):
        trb.load_zarr(written)
    # every other codec still writes
    buf.save_to_path(path, compressors={"runs_8": {"id": "gzip"}})
    monkeypatch.undo()
    _assert_equal(jrb.load_zarr(path), buf)
    shutil.rmtree(path)
