"""The port's zstd frame decoder (`data/native.py::zstd_decompress`, C++ in
`csrc/window_sampler.cpp`) against the `zstandard` package, on CPU.

The decoder's output must equal zstandard's byte for byte:
- frames at levels 1, 3, 5, 19 and 22, with and without the content
  checksum and the content size, on text, random, repetitive and float
  payloads (Huffman literals in one and four streams, raw and RLE
  literals, predefined, RLE, FSE and repeated sequence tables, repeat
  offsets, all of which zstandard's levels produce on these);
- frames of several blocks (over 128 KiB), an empty payload, concatenated
  and skippable frames;
- a hypothesis property over random and repetitive bytes;
- every zstd stream of every chunk of `data/eval_shared` but `img`, and of
  three `img` chunks (slow).
The host library's bitshuffle undone (the other half of the store's
blosc filter) equals its numpy formulation.
A truncated or corrupted frame raises ValueError (or, where a flipped bit
still leaves a well-formed frame, decodes to bytes the checksum catches);
nothing reads past a buffer.
"""

import json
import pathlib

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from state_policy_diffusionmodel_torch.data import native
from state_policy_diffusionmodel_torch.data import replay_buffer as trb

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED = REPO / "data" / "eval_shared" / \
    "shared_eval_dataset_6_episodes_3_drivers.zarr"


def _payloads():
    rng = np.random.default_rng(0)
    text = (b"The quick brown fox jumps over the lazy dog. " * 400
            + bytes(range(256)) * 8)
    floats = np.sin(np.arange(40_000) / 37.0).astype(np.float32).tobytes()
    return {
        "text": text,
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        "few_symbols": rng.integers(0, 6, 70_000, dtype=np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 256, 900, dtype=np.uint8),
                          rng.integers(1, 300, 900)).tobytes(),
        "floats": floats,
        "one_byte": b"x",
    }


PAYLOADS = _payloads()


def _check(frame: bytes, want: bytes):
    assert native.zstd_decompress(frame, len(want)) == want
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(1, len(want))) == want


@pytest.mark.parametrize("level", [1, 3, 5, 19, 22])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("content_size", [True, False])
def test_levels_checksum_and_content_size(level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in PAYLOADS.items():
        frame = c.compress(data)
        assert native.zstd_decompress(frame, len(data)) == data, name


@pytest.mark.parametrize("level", [1, 5, 19])
def test_multi_block_frames(level):
    rng = np.random.default_rng(level)
    # 600 KiB: five 128 KiB blocks and a partial one, mixed content so
    # that the blocks take different literal and sequence modes
    parts = [rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes(),
             b"\0" * 100_000,
             np.cumsum(rng.integers(-2, 3, 120_000)).astype(
                 np.int16).tobytes(),
             (b"abcdefgh" * 20_000)]
    data = b"".join(parts)
    assert len(data) > 4 * 128 * 1024
    for checksum in (True, False):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum).compress(data)
        _check(frame, data)
    # a streamed frame states no content size: the caller's size bounds it
    cobj = zstandard.ZstdCompressor(level=level).compressobj()
    frame = b"".join(cobj.compress(p) for p in parts) + cobj.flush()
    assert zstandard.get_frame_parameters(frame).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    _check(frame, data)


def test_empty_payload_and_frame_sequences():
    for checksum in (True, False):
        frame = zstandard.ZstdCompressor(write_checksum=checksum).compress(b"")
        assert native.zstd_decompress(frame, 0) == b""
    a, b = PAYLOADS["text"], PAYLOADS["floats"]
    c = zstandard.ZstdCompressor(level=3)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    frames = c.compress(a) + skippable + c.compress(b)
    assert native.zstd_decompress(frames, len(a) + len(b)) == a + b


@settings(max_examples=60, deadline=None)
@given(st.one_of(
    st.binary(min_size=0, max_size=3000),
    st.builds(lambda chunk, n: chunk * n,
              st.binary(min_size=1, max_size=40), st.integers(1, 400))),
    st.sampled_from([1, 3, 9, 19]), st.booleans())
def test_property_random_and_repetitive_bytes(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert native.zstd_decompress(frame, len(data)) == data


def test_truncated_and_corrupted_frames_raise():
    data = PAYLOADS["text"] + PAYLOADS["few_symbols"]
    frame = zstandard.ZstdCompressor(level=19,
                                     write_checksum=True).compress(data)
    for n in (0, 1, 3, 4, 5, 9, len(frame) // 2, len(frame) - 5,
              len(frame) - 1):
        with pytest.raises(ValueError):
            native.zstd_decompress(frame[:n], len(data))
    with pytest.raises(ValueError, match="does not fit"):
        native.zstd_decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match="expected"):
        native.zstd_decompress(frame, len(data) + 1)
    bad_magic = b"\x29" + frame[1:]
    with pytest.raises(ValueError, match="malformed"):
        native.zstd_decompress(bad_magic, len(data))
    dictionary = bytearray(zstandard.ZstdCompressor(level=3).compress(b"hi"))
    dictionary[4] |= 1                     # Dictionary_ID_flag = 1
    dictionary[6:6] = b"\x07"              # dictionary id 7
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(bytes(dictionary), 2)
    # every single flipped byte after the header: an error, or bytes that
    # fail the content checksum; never a crash or a read past the buffer
    rng = np.random.default_rng(3)
    for pos in rng.choice(np.arange(6, len(frame)), 200, replace=False):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = native.zstd_decompress(bytes(bad), len(data))
        except ValueError:
            continue
        assert out == data       # a flip in an unused padding bit
    # a flipped content byte in a raw block fails the checksum
    raw = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(
        bytes(np.random.default_rng(4).integers(0, 256, 300, np.uint8)))
    bad = bytearray(raw)
    bad[-10] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        native.zstd_decompress(bytes(bad), 300)


@pytest.mark.parametrize("typesize", [1, 2, 3, 4, 8, 16])
def test_bitunshuffle_equals_numpy(typesize):
    """The host library's bitshuffle undone equals the numpy formulation
    (bit planes unpacked and transposed), on blocks of 8 to 4,096
    elements; a block of no multiple of 8 elements is refused."""
    rng = np.random.default_rng(typesize)
    for elems in (8, 64, 1024, 4096):
        block = rng.integers(0, 256, elems * typesize, dtype=np.uint8)
        planes = np.unpackbits(block.reshape(typesize * 8, elems // 8),
                               axis=1, bitorder="little")
        want = np.packbits(planes.T, axis=1, bitorder="little").reshape(-1)
        np.testing.assert_array_equal(native.bitunshuffle(block, typesize),
                                      want)
    with pytest.raises(ValueError, match="multiple of 8"):
        native.bitunshuffle(np.zeros(12 * typesize, np.uint8), typesize)


def _zstd_streams(blob: bytes):
    """The compressed zstd streams of one blosc chunk, with their sizes."""
    head = np.frombuffer(blob, np.uint8, 4)
    flags, typesize = int(head[2]), int(head[3])
    nbytes, blocksize, cbytes = (int(v) for v in
                                 np.frombuffer(blob, "<u4", 3, 4))
    assert flags >> 5 == 4, "not blosc-zstd"
    if flags & 0x2:
        return []
    nblocks = -(-nbytes // blocksize)
    starts = [int(v) for v in np.frombuffer(blob, "<i4", nblocks, 16)]
    out = []
    for i, (lo, hi) in enumerate(zip(starts, starts[1:] + [cbytes])):
        bsize = min(blocksize, nbytes - i * blocksize)
        split = (not flags & 0x10 and bsize == blocksize and typesize <= 16
                 and bsize // typesize >= 128)
        parts = trb._blosc_streams(blob, lo, hi, typesize if split else 1,
                                   bsize)
        size = bsize // len(parts)
        out += [(p, size) for p in parts if len(p) != size]
    return out


def _chunks(key):
    meta = json.loads((SHARED / key / ".zarray").read_text())
    names = sorted((p.name for p in (SHARED / key).iterdir()
                    if not p.name.startswith(".")),
                   key=lambda n: int(n.split(".")[0]))
    if key == "data/img":
        names = [names[0], names[len(names) // 2], names[-1]]
    return meta, names


@pytest.mark.slow
@pytest.mark.parametrize("key", ["data/action", "data/angle",
                                 "data/car_state", "data/position",
                                 "data/velocity", "data/img",
                                 "meta/episode_ends", "meta/track_seed",
                                 "meta/driver_id"])
def test_every_stream_of_the_shared_store(key):
    meta, names = _chunks(key)
    assert meta["compressor"]["cname"] == "zstd"
    n = 0
    for name in names:
        for data, size in _zstd_streams((SHARED / key / name).read_bytes()):
            want = zstandard.ZstdDecompressor().decompress(
                data, max_output_size=size)
            assert native.zstd_decompress(data, size) == want, (key, name)
            n += 1
    # the meta arrays' few bytes are stored as they are (no zstd stream)
    assert n > 0 or key.startswith("meta/")
