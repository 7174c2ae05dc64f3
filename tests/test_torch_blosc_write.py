"""The port's blosc writer (`data/native.py::blosc_compress`, C++ in
`csrc/blosc_codec.cpp`, and `data/replay_buffer.py`'s compressor presets)
against the JAX package's tensorstore, on CPU.

- Stores the port writes with blosc zstd, lz4, lz4hc and zlib, shuffle 0,
  1 and 2 and clevel 0 and 5 are read by the JAX package's `load_zarr`
  (tensorstore's c-blosc) bit for bit: typesize 1, 4 and 8, a partial last
  chunk, a leftover block, blocks whose element count is not a multiple of
  8, all-zero, long-run and random (incompressible) arrays. Each `.zarray`
  names the compressor the JAX package's names for the same call.
- `save_to_path` with no compressors, a preset's name or a per-key dict
  writes, key by key, the compressor the JAX package's
  `_resolve_compressor` gives, and the port's and the JAX package's live
  stores fed the same episodes load to equal arrays in either package.
- The zstd encoder's frames decode with `zstandard` and with the port's
  decoder, the LZ4 encoder's blocks with the port's decoder; a hypothesis
  property over random and repetitive bytes for both.
- The forward shuffles are the exact inverses of the reader's.
- On 12 `img` chunks of the committed shared store the port's zstd-5 with
  bitshuffle takes no more bytes than zlib level 1 (the ratio to c-blosc's
  bytes on disk is printed).
- Nothing falls back: a spec both packages refuse raises naming it, and
  a library that does not build or an encoder that fails raises.
"""

import json
import os
import pathlib
import zlib

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch.data import native
from state_policy_diffusionmodel_torch.data import replay_buffer as trb

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED_IMG = REPO / "data" / "eval_shared" / \
    "shared_eval_dataset_6_episodes_3_drivers.zarr" / "data" / "img"


def _buffer(n, seed):
    rng = np.random.default_rng(seed)
    buf = trb.ReplayBuffer()
    buf.add_episode({
        "img": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
        "position": np.cumsum(rng.normal(size=(n, 2)), 0).astype(np.float32),
        "action": np.round(rng.normal(size=(n, 3)), 2).astype(np.float32),
        "step": np.arange(n, dtype=np.int64) * 3,
        "zeros": np.zeros((n, 2), np.float32),
        "runs": np.repeat(rng.integers(0, 9, n // 50 + 1), 50)[:n]
        .astype(np.uint8),
        "noise": rng.normal(size=(n,))})
    buf.meta["track_seed"] = np.array([42], np.int64)
    return buf


def _compressors(path):
    out = {}
    for group in ("data", "meta"):
        for k in sorted(os.listdir(os.path.join(path, group))):
            if not k.startswith("."):
                with open(os.path.join(path, group, k, ".zarray")) as f:
                    out[f"{group}/{k}"] = json.load(f)["compressor"]
    return out


def _assert_equal(got, buf):
    assert sorted(got.data) == sorted(buf.data)
    for k, v in buf.data.items():
        got_k = np.asarray(got.data[k])
        assert got_k.dtype == v.dtype and np.array_equal(got_k, v), k
    assert np.array_equal(got.episode_ends, buf.episode_ends)
    assert sorted(got.meta) == sorted(buf.meta)
    for k, v in buf.meta.items():
        assert np.array_equal(got.meta[k], v), k


@pytest.mark.parametrize("clevel", [0, 5])
@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", ["zstd", "lz4", "lz4hc", "zlib"])
def test_port_blosc_stores_read_back_exactly_in_tensorstore(
        tmp_path, cname, shuffle, clevel):
    # 70,001 rows in chunks of 33,333: a partial last chunk; the 8-byte
    # arrays' leftover blocks hold element counts that are not multiples
    # of 8, which bitshuffle stores as they are
    buf = _buffer(70001, seed=shuffle + 3 * clevel)
    comp = {"id": "blosc", "cname": cname, "clevel": clevel,
            "shuffle": shuffle}
    comps = {k: comp for k in [*buf.data, "episode_ends", *buf.meta]}
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, chunk_length=33333, compressors=comps)
    _assert_equal(jrb.load_zarr(path), buf)
    _assert_equal(trb.load_zarr(path), buf)
    jrb.save_zarr(buf, ref, chunk_length=33333, compressors=comps)
    assert _compressors(path) == _compressors(ref)


@pytest.mark.parametrize("compressors", [
    None, "disk", "default",
    {"img": {"id": "blosc", "cname": "lz4hc", "clevel": 9, "shuffle": 2},
     "position": {"id": "zlib", "level": 1}, "action": None,
     "step": {"id": "blosc", "cname": "zlib", "clevel": 3, "shuffle": 1},
     "episode_ends": None}],
    ids=["none", "disk", "default", "per_key"])
def test_compressors_resolve_as_in_the_jax_package(tmp_path, compressors):
    buf = _buffer(3000, seed=7)
    path, ref = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    buf.save_to_path(path, compressors=compressors)
    jrb.save_zarr(buf, ref, compressors=compressors)
    got, want = _compressors(path), _compressors(ref)
    assert got == want
    for name, spec in got.items():
        key = name.split("/")[1]
        asked = jrb._resolve_compressor(compressors, key)
        if asked is None:
            assert spec is None, name
        else:
            assert {k: spec[k] for k in asked} == asked, name
    _assert_equal(jrb.load_zarr(path), buf)
    _assert_equal(trb.load_zarr(ref), buf)


def test_live_stores_of_both_packages_load_alike(tmp_path):
    """The same episodes through the port's and the JAX package's
    ZarrReplayBuffer (default compressor, chunks straddling episodes):
    either store loads to the episodes in either package."""
    rng = np.random.default_rng(3)
    eps = [{"img": rng.random((n, 6, 6, 3), np.float32),
            "action": rng.normal(size=(n, 3)).astype(np.float32),
            "step": np.arange(n, dtype=np.int64)} for n in (7, 12, 5)]
    ref = trb.ReplayBuffer()
    stores = {}
    for name, mod in (("port", trb), ("jax", jrb)):
        stores[name] = str(tmp_path / f"{name}.zarr")
        z = mod.ZarrReplayBuffer(stores[name], chunk_length=4)
        for ep in eps:
            z.add_episode(ep)
    for ep in eps:
        ref.add_episode(ep)
    assert _compressors(stores["port"]) == _compressors(stores["jax"])
    for path in stores.values():
        for mod in (trb, jrb):
            _assert_equal(mod.load_zarr(path), ref)


def _payloads():
    rng = np.random.default_rng(0)
    return {
        "empty": b"", "one_byte": b"x",
        "zeros": bytes(300_000),
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        "text": b"The quick brown fox jumps over the lazy dog. " * 4000,
        "few_symbols": rng.integers(0, 6, 70_000, dtype=np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 256, 900, dtype=np.uint8),
                          rng.integers(1, 300, 900)).tobytes(),
        "floats": np.cumsum(rng.normal(size=60_000)).astype(np.float32)
        .tobytes(),
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("clevel", [1, 5, 9])
def test_zstd_frames_decode_with_zstandard_and_the_port(clevel):
    for name, data in PAYLOADS.items():
        frame = native.zstd_compress(data, clevel)
        params = zstandard.get_frame_parameters(frame)
        assert params.content_size == len(data) and not params.dict_id
        assert zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=max(1, len(data))) == data, name
        assert native.zstd_decompress(frame, len(data)) == data, name
        # a frame never grows by more than its header and block headers
        assert len(frame) <= len(data) + 14 + 3 * (len(data) // 131072 + 1)


@pytest.mark.parametrize("hc", [False, True])
def test_lz4_blocks_decode_with_the_port(hc):
    for name, data in PAYLOADS.items():
        block = native.lz4_compress(data, 5, hc)
        assert native.lz4_decompress(block, len(data)) == data, name
    assert len(native.lz4_compress(PAYLOADS["text"], 5, hc)) < 2000


def _lz4_sequences(block: bytes, n: int):
    """(start of each match, end of each match) in the decoded output."""
    ip, op, out = 0, 0, []
    while ip < len(block):
        token = block[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                lit += block[ip]
                ip += 1
                if block[ip - 1] != 255:
                    break
        ip += lit
        op += lit
        if ip == len(block):
            break
        ip += 2
        ml = token & 15
        if ml == 15:
            while True:
                ml += block[ip]
                ip += 1
                if block[ip - 1] != 255:
                    break
        out.append((op, op + ml + 4))
        op += ml + 4
    assert op == n
    return out


def test_lz4_end_of_block_rules():
    for name, data in PAYLOADS.items():
        n = len(data)
        for start, end in _lz4_sequences(native.lz4_compress(data, 9, True),
                                         n):
            assert start <= n - 12 and end <= n - 5, name


@settings(max_examples=60, deadline=None)
@given(st.one_of(
    st.binary(min_size=0, max_size=3000),
    st.builds(lambda chunk, n: chunk * n,
              st.binary(min_size=1, max_size=40), st.integers(1, 400))),
    st.sampled_from([1, 5, 9]))
def test_property_random_and_repetitive_bytes(data, clevel):
    frame = native.zstd_compress(data, clevel)
    assert native.zstd_decompress(frame, len(data)) == data
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(1, len(data))) == data
    block = native.lz4_compress(data, clevel, clevel == 9)
    assert native.lz4_decompress(block, len(data)) == data


@pytest.mark.parametrize("typesize", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("size", [0, 7, 64, 96, 1000, 4099])
def test_shuffles_invert_the_readers(typesize, size):
    block = np.random.default_rng(size + typesize).integers(
        0, 256, size, dtype=np.uint8)
    shuffled = native.shuffle(block, typesize)
    assert np.array_equal(trb._unshuffle(shuffled, typesize), block)
    bits = native.bitshuffle(block, typesize)
    assert np.array_equal(trb._bitunshuffle(bits, typesize), block)
    elems = size // typesize
    tail = elems * typesize     # the bytes past the last whole element
    assert np.array_equal(shuffled[tail:], block[tail:])
    assert np.array_equal(bits[tail:], block[tail:])
    if elems % 8 == 0 and elems:
        # plane b * 8 + i: bit i of byte b of every element, packed least
        # significant bit first
        bits_of = np.unpackbits(block[:elems * typesize].reshape(
            elems, typesize, 1), axis=2, bitorder="little")
        want = np.packbits(bits_of.transpose(1, 2, 0).reshape(
            typesize * 8, elems), axis=1, bitorder="little")
        assert np.array_equal(bits[:elems * typesize], want.reshape(-1))


def test_shared_img_chunks_take_no_more_than_zlib_1():
    raw, disk = [], 0
    for i in range(0, 661, 60):
        blob = (SHARED_IMG / f"{i}.0.0.0").read_bytes()
        disk += len(blob)
        raw.append(trb._blosc_decode(blob))
    ours = [native.blosc_compress(r, 4, "zstd", 5, 2) for r in raw]
    assert [trb._blosc_decode(o) for o in ours] == raw
    port, zlib1 = sum(map(len, ours)), sum(len(zlib.compress(r, 1))
                                          for r in raw)
    print(f"12 img chunks ({sum(map(len, raw))} bytes): port blosc zstd-5 "
          f"bitshuffle {port} bytes, {port / disk:.4f}x c-blosc's {disk}; "
          f"zlib-1 {zlib1}")
    assert port <= zlib1


def test_nothing_falls_back(tmp_path, monkeypatch):
    buf = _buffer(500, seed=1)
    # blosclz and snappy are written now; a spec both packages refuse
    # raises naming it, before any chunk is written
    for bad, named in (({"id": "blosc", "cname": "ndlz", "clevel": 5,
                         "shuffle": 1}, "ndlz"),
                       ({"id": "lz4"}, "lz4")):
        path = str(tmp_path / f"{named}.zarr")
        with pytest.raises(ValueError, match=named):
            buf.save_to_path(path, compressors={"img": bad})
        assert not os.path.exists(path)
        with pytest.raises(ValueError):
            jrb.save_zarr(buf, str(tmp_path / f"jax_{named}.zarr"),
                          compressors={"img": bad})
    with pytest.raises(ValueError, match="ndlz"):
        native.blosc_compress(b"\0" * 1000, 4, "ndlz", 5, 1)

    @native._STREAM_ENCODER
    def failing(src, n, dst, cap, clevel):
        return -1

    monkeypatch.setattr(native, "_zlib_stream", failing)
    with pytest.raises(ValueError, match="encoder failed"):
        buf.save_to_path(str(tmp_path / "zlib.zarr"), compressors={
            "img": {"id": "blosc", "cname": "zlib", "clevel": 5,
                    "shuffle": 0}})

    def no_library(name):
        raise RuntimeError(f"build failed: {name}")

    monkeypatch.setattr(native.build, "library", no_library)
    path = str(tmp_path / "nolib.zarr")
    with pytest.raises(RuntimeError, match="blosc_codec"):
        buf.save_to_path(path)
    assert not os.path.exists(os.path.join(path, "data", "img", "0.0.0.0"))


@pytest.mark.parametrize("bad", [{"blocksize": -1}, {"clevel": 10},
                                 {"shuffle": 3}])
def test_unwritten_blosc_settings_raise_before_writing(tmp_path, bad):
    """A negative blocksize, a clevel outside 0-9 or a shuffle outside
    -1..2 (each refused by tensorstore too) is refused before any chunk is
    written."""
    buf = _buffer(500, seed=1)
    path = str(tmp_path / "bad.zarr")
    comps = {"img": {"id": "blosc", "cname": "zstd", "clevel": 5,
                     "shuffle": 2, **bad}}
    with pytest.raises(ValueError, match=next(iter(bad))):
        buf.save_to_path(path, compressors=comps)
    assert not os.path.exists(os.path.join(path, "data", "img", "0.0.0.0"))
    with pytest.raises(ValueError):
        jrb.save_zarr(buf, str(tmp_path / "jax.zarr"), compressors=comps)
