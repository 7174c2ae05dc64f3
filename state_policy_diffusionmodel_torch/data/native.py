"""ctypes bindings of the port's host library (`csrc/window_sampler.cpp`
and `csrc/blosc_codec.cpp`).

Counterpart of `state_policy_diffusionmodel_tpu/data/native.py`, over the
port's own copy of the C++: `kernels/build.py` compiles it with the host
C++ compiler into `build/` at the first call (the JAX package's library is
built by hand with make). A build or load failure raises with the
compiler's log; there is no numpy fallback here. The numpy versions in
`data/dataset.py` are the plain versions and the tests' oracles, and the
library's results equal them bit for bit.

  gather_windows(src, starts, seq_len, step) -> (B, seq_len, *src.shape[1:])
      float32 sources are copied; uint8 sources are converted to float32
      and divided by 255 (raw image frames).
  normalize_positions(pos, stat_min, stat_max) -> (pos_norm, translations)
      per-window position normalization with the reference's semantics
      (utils/load_data.py:85-89): min-max to [-1, 1],
      subtract the window's first frame, divide by 2.
  lz4_decompress(block, size) -> bytes, one raw LZ4 block (blosc's lz4 and
      lz4hc streams).
  zstd_decompress(data, size) -> bytes, zstd frames (RFC 8878; blosc's
      zstd streams) holding `size` bytes, with a hand-written decoder: a
      malformed or truncated input, or one of another size, raises
      ValueError.
  bitunshuffle(block, typesize) -> uint8 array, blosc's bitshuffle of one
      block of a multiple of 8 elements undone.

From `blosc_codec.cpp` (the write side of blosc and of zarr's zstd, and
the two blosc codecs the reader above does not decode):

  blosc_compress(raw, typesize, cname, clevel, shuffle, blocksize=0) ->
      bytes, one blosc1 chunk at c-blosc's block size, or at a forced one
      as c-blosc forces it (every cname tensorstore takes: blosclz, lz4,
      lz4hc, snappy and zstd through the library, zlib through Python's
      zlib, called by the library a stream); shuffle -1 is tensorstore's
      auto: bitshuffle at typesize 1, byte shuffle otherwise. The chunk's
      block size is c-blosc's for the same call, and so are its flags
      wherever the encoders agree on whether a stream fits its room.
  zstd_compress(data, clevel) -> bytes, one zstd frame (hand-written
      encoder). lz4_compress(data, clevel, hc=False) -> bytes, one raw LZ4
      block. blosclz_compress(data, clevel), snappy_compress(data,
      clevel) -> bytes, one stream each.
  shuffle(block, typesize), bitshuffle(block, typesize) -> uint8 array,
      blosc's shuffles of one block, forward.
  blosclz_decompress(data, size), snappy_decompress(data, size) -> bytes.

What a zarr store may ask of these is bounded in one table,
`replay_buffer.ZARR_COMPRESSORS`. An encoder that fails, or arguments the
library does not take, raise; nothing is written in another codec's place.
"""

from __future__ import annotations

import ctypes
import os
import zlib

import numpy as np

from ..kernels import build

N_THREADS = min(8, os.cpu_count() or 1)

def library() -> ctypes.CDLL:
    """The host library, built and loaded at the first call."""
    lib = build.library("window_sampler")
    if not getattr(lib, "typed", False):
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.gather_windows_f32.argtypes = [ptr, i64, ptr, i64, i64, i64, ptr,
                                           ctypes.c_int]
        lib.gather_windows_f32.restype = None
        lib.gather_windows_u8_to_f32.argtypes = [ptr, i64, ptr, i64, i64, i64,
                                                 ptr, ctypes.c_int]
        lib.gather_windows_u8_to_f32.restype = None
        lib.normalize_positions_f32.argtypes = [
            ptr, i64, i64, ctypes.c_float, ctypes.c_float, ptr, ctypes.c_int]
        lib.normalize_positions_f32.restype = None
        lib.lz4_decompress_block.argtypes = [ptr, i64, ptr, i64]
        lib.lz4_decompress_block.restype = i64
        lib.zstd_decompress.argtypes = [ptr, i64, ptr, i64]
        lib.zstd_decompress.restype = i64
        lib.bitunshuffle.argtypes = [ptr, i64, i64, ptr]
        lib.bitunshuffle.restype = None
        lib.typed = True
    return lib


def gather_windows(src: np.ndarray, starts: np.ndarray, seq_len: int,
                   step: int) -> np.ndarray:
    """B strided windows, rows start, start+step, ... of src (T, ...), as
    float32 (B, seq_len, ...); uint8 sources divided by 255."""
    lib = library()
    src = np.ascontiguousarray(src)
    if src.dtype not in (np.uint8, np.float32):
        src = src.astype(np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    batch = int(starts.shape[0])
    if batch and (starts.min() < 0 or starts.max() + (seq_len - 1) * step
                  >= src.shape[0]):
        raise IndexError(f"windows of {seq_len} rows every {step} from "
                         f"starts {starts.min()}..{starts.max()} leave the "
                         f"{src.shape[0]} rows of the source")
    feat = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((batch, seq_len) + src.shape[1:], np.float32)
    fn = (lib.gather_windows_u8_to_f32 if src.dtype == np.uint8
          else lib.gather_windows_f32)
    fn(src.ctypes.data, feat, starts.ctypes.data, batch, seq_len, step,
       out.ctypes.data, N_THREADS)
    return out


def normalize_positions(pos: np.ndarray, stat_min: float, stat_max: float):
    """(B, T, 2) raw positions -> (normalized, (B, 2) first-frame
    translations in [-1, 1] space); the caller's array is not changed."""
    lib = library()
    # a copy: the library normalizes in place
    pos = np.array(pos, np.float32, copy=True, order="C")
    batch, seq_len = int(pos.shape[0]), int(pos.shape[1])
    trans = np.empty((batch, 2), np.float32)
    lib.normalize_positions_f32(pos.ctypes.data, batch, seq_len,
                                float(stat_min), float(stat_max),
                                trans.ctypes.data, N_THREADS)
    return pos, trans


def lz4_decompress(block: bytes, size: int) -> bytes:
    """The `size` bytes one raw LZ4 block decodes to; raises if the block is
    malformed or decodes to another size."""
    lib = library()
    src = np.frombuffer(block, np.uint8)
    out = np.empty(size, np.uint8)
    n = lib.lz4_decompress_block(src.ctypes.data, src.size, out.ctypes.data,
                                 size)
    if n != size:
        raise ValueError(f"an LZ4 block of {src.size} bytes decoded to {n} "
                         f"bytes, expected {size}")
    return out.tobytes()


_ZSTD_ERRORS = {-1: "is malformed or truncated",
                -2: "does not fit in {cap} bytes",
                -3: "needs a dictionary, which this decoder does not take",
                -4: "fails its content checksum"}


def zstd_decompress(data: bytes, size: int) -> bytes:
    """The `size` bytes of content of the zstd frames in `data` (a blosc
    stream's size is in its chunk header). Raises ValueError on a malformed
    or truncated input, or one whose content is not `size` bytes."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    size = int(size)
    out = np.empty(max(size, 1), np.uint8)
    n = lib.zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, size)
    if n < 0:
        raise ValueError(f"a zstd input of {src.size} bytes "
                         + _ZSTD_ERRORS[n].format(cap=size))
    if n != size:
        raise ValueError(f"a zstd input of {src.size} bytes decoded to {n} "
                         f"bytes, expected {size}")
    return out[:n].tobytes()


def bitunshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """The elements of one bitshuffled block (uint8, a multiple of 8
    elements of `typesize` bytes, nothing after the last)."""
    block = np.ascontiguousarray(block, np.uint8)
    elems = block.size // typesize
    if elems % 8 or elems * typesize != block.size:
        raise ValueError(f"a bitshuffled block holds a multiple of 8 whole "
                         f"elements, not {block.size} bytes of {typesize}")
    out = np.empty_like(block)
    library().bitunshuffle(block.ctypes.data, elems, typesize,
                           out.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# blosc_codec.cpp
# ---------------------------------------------------------------------------

# blosc1's compressor format codes (a chunk header's flags >> 5); lz4hc is
# written under lz4's code. Every cname tensorstore takes, written and read.
BLOSC_CODES = {"blosclz": 0, "lz4": 1, "snappy": 2, "zlib": 3, "zstd": 4}
BLOSC_CNAMES = ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")

_STREAM_ENCODER = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int)


@_STREAM_ENCODER
def _zlib_stream(src, n, dst, cap, clevel):
    """One blosc stream through Python's zlib (c-blosc's compress2 at the
    chunk's clevel); 0 where it does not fit, -1 on an error."""
    try:
        out = zlib.compress(ctypes.string_at(src, n), clevel)
        if len(out) > cap:
            return 0
        ctypes.memmove(dst, out, len(out))
        return len(out)
    except Exception:       # raised as ValueError by blosc_compress
        return -1


def codec_library() -> ctypes.CDLL:
    """The blosc codec library, built and loaded at the first call."""
    lib = build.library("blosc_codec")
    if not getattr(lib, "typed", False):
        i64, ptr, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.blosc_compress.argtypes = [ptr, i64, i64, i32, i32, i32, i32, i32,
                                       ptr, i64, i32, _STREAM_ENCODER]
        lib.blosc_compress.restype = i64
        lib.zstd_compress.argtypes = [ptr, i64, ptr, i64, i32]
        lib.zstd_compress.restype = i64
        lib.lz4_compress.argtypes = [ptr, i64, ptr, i64, i32, i32]
        lib.lz4_compress.restype = i64
        for name in ("blosclz_compress", "snappy_compress"):
            getattr(lib, name).argtypes = [ptr, i64, ptr, i64, i32]
            getattr(lib, name).restype = i64
        for name in ("shuffle", "bitshuffle"):
            getattr(lib, name).argtypes = [ptr, i64, i64, ptr]
            getattr(lib, name).restype = None
        for name in ("blosclz_decompress", "snappy_decompress"):
            getattr(lib, name).argtypes = [ptr, i64, ptr, i64]
            getattr(lib, name).restype = i64
        lib.typed = True
    return lib


_BLOSC_ERRORS = {-1: "bad arguments", -2: "an encoder failed",
                 -4: "the output is too small"}


def blosc_compress(raw, typesize: int, cname: str, clevel: int,
                   shuffle: int, blocksize: int = 0) -> bytes:
    """`raw` as one blosc1 chunk that c-blosc (tensorstore) reads back, at
    c-blosc's block size (blocksize 0) or a forced one, which c-blosc takes
    as a 32-bit int (2**32 + 4096 forces 4096, 2**31 is negative and so
    its floor, 128); shuffle 0 (none), 1 (bytes), 2 (bits) or -1
    (tensorstore's auto: bits at typesize 1, bytes otherwise). Raises
    ValueError for a cname outside BLOSC_CNAMES, arguments the library
    does not take, or an encoder that fails."""
    if cname not in BLOSC_CNAMES:
        raise ValueError(f"blosc cname {cname!r}: this package writes "
                         f"{list(BLOSC_CNAMES)}")
    if shuffle == -1:
        shuffle = 2 if typesize == 1 else 1
    forced = (int(blocksize) + 2 ** 31) % 2 ** 32 - 2 ** 31
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(src.size + 16, np.uint8)
    n = codec_library().blosc_compress(
        src.ctypes.data, src.size, int(typesize), int(clevel), int(shuffle),
        BLOSC_CODES["lz4" if cname == "lz4hc" else cname],
        int(cname == "lz4hc"), forced, out.ctypes.data, out.size,
        N_THREADS, _zlib_stream)
    if n < 0:
        raise ValueError(f"blosc {cname} (clevel {clevel}, shuffle "
                         f"{shuffle}, blocksize {blocksize}) of {src.size} "
                         f"bytes failed: {_BLOSC_ERRORS[n]}")
    return out[:n].tobytes()


def _encoded(fn, data: bytes, what: str, *args) -> bytes:
    src = np.frombuffer(data, np.uint8)
    cap = src.size + src.size // 6 + 64   # every encoder's worst case
    out = np.empty(cap, np.uint8)
    n = fn(src.ctypes.data, src.size, out.ctypes.data, cap, *args)
    if n < 0 or (n == 0 and src.size):
        raise ValueError(f"{what} of {src.size} bytes failed ({n})")
    return out[:n].tobytes()


def zstd_compress(data: bytes, clevel: int = 5) -> bytes:
    """One zstd frame holding `data` (its content size in the header),
    at blosc's clevel 1-9 (the match search's depth)."""
    return _encoded(codec_library().zstd_compress, data, "zstd", int(clevel))


def lz4_compress(data: bytes, clevel: int = 5, hc: bool = False) -> bytes:
    """One raw LZ4 block holding `data` (lz4hc's deeper search with hc)."""
    return _encoded(codec_library().lz4_compress, data, "lz4", int(clevel),
                    int(hc))


def blosclz_compress(data: bytes, clevel: int = 5) -> bytes:
    """One blosclz stream holding `data` (the hash chain's depth from
    blosc's clevel 1-9, as lz4's); ends in literals, as c-blosc's decoder
    needs."""
    return _encoded(codec_library().blosclz_compress, data, "blosclz",
                    int(clevel))


def snappy_compress(data: bytes, clevel: int = 5) -> bytes:
    """One raw snappy stream holding `data` (offsets within 65535)."""
    return _encoded(codec_library().snappy_compress, data, "snappy",
                    int(clevel))


def _shuffled(name: str, block, typesize: int) -> np.ndarray:
    block = np.ascontiguousarray(np.frombuffer(block, np.uint8))
    out = np.zeros_like(block)
    getattr(codec_library(), name)(block.ctypes.data, block.size,
                                   int(typesize), out.ctypes.data)
    return out


def shuffle(block, typesize: int) -> np.ndarray:
    """blosc's byte shuffle of one block: byte plane by byte plane, the
    bytes past the last whole element as they are."""
    return _shuffled("shuffle", block, typesize)


def bitshuffle(block, typesize: int) -> np.ndarray:
    """blosc's bitshuffle of one block: bit planes of a multiple of 8
    elements, the bytes past them as they are; any other block as it is."""
    return _shuffled("bitshuffle", block, typesize)


def _decoded(fn, data: bytes, size: int, what: str) -> bytes:
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(int(size), 1), np.uint8)
    n = fn(src.ctypes.data, src.size, out.ctypes.data, int(size))
    if n != size:
        raise ValueError(f"a {what} stream of {src.size} bytes decoded to "
                         f"{n} bytes, expected {size}")
    return out[:n].tobytes()


def blosclz_decompress(data: bytes, size: int) -> bytes:
    """The `size` bytes one blosclz stream decodes to; raises if it is
    malformed or decodes to another size."""
    return _decoded(codec_library().blosclz_decompress, data, size,
                    "blosclz")


def snappy_decompress(data: bytes, size: int) -> bytes:
    """The `size` bytes one raw snappy stream decodes to; raises if it is
    malformed or decodes to another size."""
    return _decoded(codec_library().snappy_decompress, data, size, "snappy")
