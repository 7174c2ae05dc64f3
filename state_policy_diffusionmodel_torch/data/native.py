"""ctypes bindings of the port's host library (`csrc/window_sampler.cpp`).

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
"""

from __future__ import annotations

import ctypes
import os

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
