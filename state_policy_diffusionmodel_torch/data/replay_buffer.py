"""Episodic replay buffer and its zarr v2 store, with numpy and the standard
library only.

Counterpart of `state_policy_diffusionmodel_tpu/data/replay_buffer.py`.
`ReplayBuffer` is the same in-memory store: per-key arrays of all frames,
`episode_ends`, and per-episode `meta` arrays. On disk the layout is the
same zarr v2 group, `data/<key>`, `meta/episode_ends`, `meta/<key>` and a
`.zgroup` at each level, so either package reads what the other writes;
a `.zip` of such a directory is read through `zipfile`.

The JAX package writes through tensorstore with blosc by default: zstd-5
with bitshuffle (its `disk` preset) or lz4 (`default`), and passes any
other compressor dict of its caller to tensorstore's zarr v2 driver. This
module writes and reads the same compressors, each as tensorstore
normalizes and bounds it (`ZARR_COMPRESSORS`, the one table of them; a
spec outside it is refused before anything is written):

- blosc, every cname (blosclz, lz4, lz4hc, snappy, zlib, zstd), shuffle
  -1 (auto) to 2 and any blocksize: blosc1 chunks written by the port's
  host library (`data/native.py::blosc_compress`: hand-written encoders,
  forward shuffle and bitshuffle, c-blosc's block size and layout) and
  read here (`_blosc_decode`: the chunk header and block offsets,
  memcpyed chunks, split streams, zlib through `zlib`, the other codecs
  through the host library's decoders, byte shuffle undone in numpy and
  bitshuffle in the host library);
- zlib and gzip through Python's `zlib` (any gzip stream is read, one of
  several members too); bz2 through Python's `bz2`, imported where it is
  used (without it a bz2 array raises ImportError naming bz2); zstd, one
  frame a chunk, through the host library's encoder and decoder;
- no compressor.

Nothing is written in another codec's place. Arrays are written in C
order; arrays in F order are read and appended to.

`ZarrReplayBuffer` is the live on-disk store (the JAX package's, there
through tensorstore's resizable zarr driver): episodes append straight to
disk as a resize of each array's `.zarray` shape and a write of the chunks
the episode touches (a chunk that straddles two episodes is read, filled
and rewritten whole), in the order and with the compressor its `.zarray`
states, and reads load only the chunks they touch. Its compressor is the
JAX store's.
"""

from __future__ import annotations

import gzip
import itertools
import json
import math
import os
import shutil
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

from . import native

# compressor presets, the JAX package's (the reference's
# replay_buffer.py:289-295): 'default' = blosc lz4 without shuffle, 'disk'
# = blosc zstd-5 with bitshuffle, the one a store gets by default
COMPRESSOR_PRESETS = {
    "default": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 0},
    "disk": {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2},
}


def _optimal_chunk_length(shape, dtype, target_bytes=2 * 1024 * 1024) -> int:
    """~2MB chunks along the time axis (the JAX package's heuristic)."""
    item = np.dtype(dtype).itemsize * math.prod(shape[1:]) if len(shape) > 1 \
        else np.dtype(dtype).itemsize
    return max(1, min(shape[0], target_bytes // max(item, 1)))


class ReplayBuffer:
    """In-memory episodic store: dict of (T_total, ...) arrays + episode_ends.

    `meta` holds additional per-episode arrays persisted under `meta/<key>`
    in the zarr group (e.g. `track_seed (E,)`)."""

    def __init__(self, data: Optional[Dict[str, np.ndarray]] = None,
                 episode_ends: Optional[np.ndarray] = None,
                 meta: Optional[Dict[str, np.ndarray]] = None):
        self.data: Dict[str, np.ndarray] = data or {}
        self.episode_ends: np.ndarray = (
            episode_ends if episode_ends is not None
            else np.zeros(0, np.int64)
        )
        self.meta: Dict[str, np.ndarray] = meta or {}

    # -- constructors -------------------------------------------------------
    @classmethod
    def create_empty_numpy(cls) -> "ReplayBuffer":
        return cls()

    @classmethod
    def copy_from_path(cls, path: str) -> "ReplayBuffer":
        return load_zarr(path)

    # -- episode API --------------------------------------------------------
    @property
    def n_episodes(self) -> int:
        return len(self.episode_ends)

    @property
    def n_steps(self) -> int:
        return 0 if self.n_episodes == 0 else int(self.episode_ends[-1])

    def add_episode(self, episode: Dict[str, np.ndarray]) -> None:
        lengths = {k: len(v) for k, v in episode.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"episode keys disagree on length: {lengths}")
        t = next(iter(lengths.values()))
        if self.n_episodes == 0 and not self.data:
            for k, v in episode.items():
                self.data[k] = np.asarray(v).copy()
        else:
            if set(episode) != set(self.data):
                raise ValueError(
                    f"episode keys {set(episode)} != buffer keys {set(self.data)}")
            for k, v in episode.items():
                self.data[k] = np.concatenate([self.data[k], np.asarray(v)])
        self.episode_ends = np.append(self.episode_ends, self.n_steps + t)

    def get_episode(self, i: int) -> Dict[str, np.ndarray]:
        start = 0 if i == 0 else int(self.episode_ends[i - 1])
        end = int(self.episode_ends[i])
        return {k: v[start:end] for k, v in self.data.items()}

    def get_steps_slice(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        return {k: v[start:stop] for k, v in self.data.items()}

    def drop_episode(self) -> None:
        """Remove the last episode."""
        if self.n_episodes == 0:
            raise IndexError("empty buffer")
        start = 0 if self.n_episodes == 1 else int(self.episode_ends[-2])
        for k in self.data:
            self.data[k] = self.data[k][:start]
        self.episode_ends = self.episode_ends[:-1]

    def pop_episode(self) -> Dict[str, np.ndarray]:
        ep = self.get_episode(self.n_episodes - 1)
        self.drop_episode()
        return ep

    # -- persistence --------------------------------------------------------
    def save_to_path(self, path: str, chunk_length: int = -1,
                     make_zip: bool = False, compressors=None) -> None:
        """compressors: None (the `disk` preset for every key), a preset's
        name ('disk', 'default'), or a per-key dict of zarr compressor
        specs (blosc, {'id': 'zlib', 'level': L} or None for none); keys
        it does not name take `disk`. The JAX package's semantics."""
        save_zarr(self, path, chunk_length=chunk_length,
                  compressors=compressors)
        if make_zip:
            shutil.make_archive(path, "zip", path)


# ---------------------------------------------------------------------------
# zarr v2 arrays: .zarray JSON + one file per chunk
# ---------------------------------------------------------------------------

def _resolve_compressor(compressors, key: str) -> Optional[dict]:
    """The compressor of array `key`, as the JAX package resolves it: None
    -> `disk`, a preset's name -> the preset, a per-key dict -> its entry
    for the key, else `disk`."""
    if compressors is None:
        return COMPRESSOR_PRESETS["disk"]
    if isinstance(compressors, str):
        if compressors not in COMPRESSOR_PRESETS:
            raise ValueError(f"no compressor preset {compressors!r}: "
                             f"{sorted(COMPRESSOR_PRESETS)}")
        return COMPRESSOR_PRESETS[compressors]
    if isinstance(compressors, dict) and "id" not in compressors:
        return compressors.get(key, COMPRESSOR_PRESETS["disk"])
    raise ValueError(f"compressors must be None, a preset's name or a "
                     f"per-key dict, got {compressors!r}")


# Every zarr v2 compressor this module writes and reads, as tensorstore
# (the JAX package's writer) normalizes and bounds it: id -> member ->
# (its default, the values taken). A member left out takes its default;
# any other id, member or value is refused, as tensorstore refuses it.
ZARR_COMPRESSORS = {
    "blosc": {"blocksize": (0, range(0, 2 ** 64)),
              "clevel": (5, range(0, 10)),
              "cname": ("lz4", native.BLOSC_CNAMES),
              "shuffle": (-1, range(-1, 3))},
    "bz2": {"level": (1, range(1, 10))},
    "gzip": {"level": (1, range(0, 10))},
    "zlib": {"level": (1, range(0, 10))},
    "zstd": {"level": (1, range(-131072, 23))},
}


def _zarray_compressor(compressor: Optional[dict],
                       where: str = "a zarr array") -> Optional[dict]:
    """The compressor as a `.zarray` states it, each member present, as
    tensorstore writes it for the same dict; ValueError, naming what is
    refused, for a spec outside ZARR_COMPRESSORS (and ImportError for bz2
    where Python has no bz2). Called before anything is written and on
    every array read."""
    if compressor is None:
        return None
    cid = compressor.get("id") if isinstance(compressor, dict) else None
    if not isinstance(cid, str) or cid not in ZARR_COMPRESSORS:
        raise ValueError(f"{where}: zarr compressor {compressor!r} is not "
                         f"one of the ids {sorted(ZARR_COMPRESSORS)}")
    members = ZARR_COMPRESSORS[cid]
    extra = sorted(set(compressor) - set(members) - {"id"})
    if extra:
        raise ValueError(f"{where}: a zarr {cid} compressor has the members "
                         f"{sorted(members)}, not {extra}: {compressor!r}")
    spec = {"id": cid}
    for name, (default, allowed) in members.items():
        value = compressor.get(name, default)
        if isinstance(allowed, range):      # integers, 3.0 as 3; no bools
            integral = not isinstance(value, bool) and (
                isinstance(value, int)
                or isinstance(value, float) and value.is_integer())
            value = int(value) if integral else None
        if value not in allowed:
            taken = (f"{allowed.start}..{allowed.stop - 1}"
                     if isinstance(allowed, range) else list(allowed))
            raise ValueError(f"{where}: zarr {cid} {name} "
                             f"{compressor.get(name)!r} is not in {taken}")
        spec[name] = value
    if cid == "bz2":
        _bz2()
    return dict(sorted(spec.items()))


def _bz2():
    """Python's bz2 module; ImportError naming bz2 where the interpreter
    was built without it (no other codec is used in its place)."""
    try:
        import bz2
    except ImportError as e:
        raise ImportError(f"zarr bz2 arrays need Python's bz2 module, which "
                          f"this interpreter lacks: {e}") from e
    return bz2


def _zstd_effort(level: int) -> int:
    """The host zstd encoder's search effort (blosc's clevel 1-9) for a
    zarr zstd level: the inverse of c-blosc's own map from its clevel c to
    zstd's level (2c - 1 up to 7, then 20 and 22), the largest effort
    whose zstd level is at most the one asked. Level 0 is zstd's default,
    3; levels 2 and below (the negative ones among them) take the fastest
    search, a greedy one of 4 candidates."""
    level = 3 if level == 0 else level
    if level >= 22:
        return 9
    if level >= 20:
        return 8
    if level >= 13:
        return 7
    return max(1, (level + 1) // 2)


def _encode(raw: bytes, compressor: Optional[dict], typesize: int) -> bytes:
    """One chunk's bytes as its compressor (a `_zarray_compressor` spec)
    stores them; `typesize` is the dtype's item size."""
    if compressor is None:
        return raw
    cid = compressor["id"]
    if cid == "zlib":
        return zlib.compress(raw, compressor["level"])
    if cid == "gzip":
        enc = zlib.compressobj(compressor["level"], zlib.DEFLATED, 31)
        return enc.compress(raw) + enc.flush()
    if cid == "bz2":
        return _bz2().compress(raw, compressor["level"])
    if cid == "zstd":
        return native.zstd_compress(raw, _zstd_effort(compressor["level"]))
    return native.blosc_compress(raw, typesize, compressor["cname"],
                                 compressor["clevel"], compressor["shuffle"],
                                 compressor["blocksize"])


# blosc1's compressor format codes (the header's flags >> 5) -> codec
_BLOSC_CODECS = {code: name for name, code in native.BLOSC_CODES.items()}


def _blosc_stream(data: bytes, codec: str, size: int) -> bytes:
    """One compressed blosc stream decoded to its `size` bytes."""
    if codec == "lz4":
        return native.lz4_decompress(data, size)
    if codec == "zstd":
        return native.zstd_decompress(data, size)
    if codec == "blosclz":
        return native.blosclz_decompress(data, size)
    if codec == "snappy":
        return native.snappy_decompress(data, size)
    if codec == "zlib":
        out = zlib.decompress(data)
    else:
        raise ValueError(f"blosc stream compressed with {codec}: not read")
    if len(out) != size:
        raise ValueError(f"a blosc {codec} stream decoded to {len(out)} "
                         f"bytes, expected {size}")
    return out


def _unshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc's byte shuffle of one block: the first (n // typesize) *
    typesize bytes were stored byte plane by byte plane; the rest as is."""
    n = block.size // typesize * typesize
    out = block.copy()
    out[:n] = block[:n].reshape(typesize, -1).T.reshape(-1)
    return out


def _bitunshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc's bitshuffle of one block. A block of a multiple of 8
    whole elements was stored bit plane by bit plane (plane b * 8 + i holds
    bit i of byte b of every element, least significant bit first), with
    the bytes past its last whole element as they are; any other block was
    stored as it is (c-blosc's `bitshuffle` copies it)."""
    elems = block.size // typesize
    if elems % 8:
        return block
    n = elems * typesize
    out = block.copy()
    if elems:
        out[:n] = native.bitunshuffle(block[:n], typesize)
    return out


def _blosc_decode(blob: bytes) -> bytes:
    """A blosc1 chunk decoded: the 16-byte header (version, versionlz,
    flags, typesize, nbytes, blocksize, cbytes), then either the raw bytes
    (memcpyed) or one int32 offset a block and the blocks, each of one
    stream or of `typesize` split streams (an int32 size, then the bytes;
    a stream of exactly its decoded size is stored raw)."""
    head = np.frombuffer(blob, np.uint8, 4)
    flags, typesize = int(head[2]), int(head[3])
    nbytes, blocksize, cbytes = (int(v) for v in
                                 np.frombuffer(blob, "<u4", 3, 4))
    if cbytes != len(blob):
        raise ValueError(f"a blosc chunk of {len(blob)} bytes says "
                         f"{cbytes}")
    if flags & 0x2:                                    # memcpyed
        return blob[16:16 + nbytes]
    codec = _BLOSC_CODECS.get(flags >> 5, f"code {flags >> 5}")
    nblocks = -(-nbytes // blocksize)
    starts = [int(v) for v in np.frombuffer(blob, "<i4", nblocks, 16)]
    ends = starts[1:] + [cbytes]
    out = np.empty(nbytes, np.uint8)
    for i, (lo, hi) in enumerate(zip(starts, ends)):
        bsize = min(blocksize, nbytes - i * blocksize)
        leftover = bsize < blocksize
        # blosc splits a block into typesize streams unless the header says
        # it did not (0x10); a leftover block is never split
        split = (not flags & 0x10 and not leftover and typesize <= 16
                 and bsize // typesize >= 128)
        streams = _blosc_streams(blob, lo, hi, typesize if split else 1,
                                 bsize)
        if streams is None:
            raise ValueError(f"blosc block {i}: its streams do not fill "
                             f"bytes {lo}..{hi}")
        size = bsize // len(streams)
        block = np.frombuffer(b"".join(
            data if len(data) == size else _blosc_stream(data, codec, size)
            for data in streams), np.uint8)
        if flags & 0x1 and typesize > 1:
            block = _unshuffle(block, typesize)
        elif flags & 0x4 and bsize >= typesize:
            block = _bitunshuffle(block, typesize)
        out[i * blocksize:i * blocksize + bsize] = block
    return out.tobytes()


def _blosc_streams(blob: bytes, lo: int, hi: int, n: int, bsize: int):
    """The block at blob[lo:hi] as its n still compressed streams, or None
    where n streams do not fill it exactly. A stream may be longer than
    the bsize // n bytes it decodes to (c-blosc keeps a snappy stream of
    incompressible bytes that grew); one of exactly that size is raw."""
    if bsize % n:
        return None
    pos, parts = lo, []
    for _ in range(n):
        if pos + 4 > hi:
            return None
        c = int(np.frombuffer(blob, "<i4", 1, pos)[0])
        pos += 4
        if c <= 0 or pos + c > hi:
            return None
        parts.append(blob[pos:pos + c])
        pos += c
    return parts if pos == hi else None


def _decode(blob: bytes, compressor: Optional[dict], nbytes: int) -> bytes:
    """One chunk's `nbytes` raw bytes from what its compressor stored."""
    cid = None if compressor is None else compressor["id"]
    if cid is None:
        return blob
    if cid == "blosc":
        return _blosc_decode(blob)
    if cid == "zstd":       # tensorstore's frames state no content size
        return native.zstd_decompress(blob, nbytes)
    if cid == "gzip":
        return gzip.decompress(blob)
    if cid == "bz2":
        return _bz2().decompress(blob)
    return zlib.decompress(blob)


def _write_group_meta(path: str) -> None:
    """zarr group metadata so zarr tooling opens the tree."""
    for sub in ("", "data", "meta"):
        d = os.path.join(path, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, ".zgroup"), "w") as f:
            json.dump({"zarr_format": 2}, f)


def _write_array(path: str, arr: np.ndarray, chunk_len: int,
                 compressor: Optional[dict]) -> None:
    """One zarr v2 array at `path`: chunked along axis 0 only, each chunk
    the full chunk shape (the last padded with zeros, as zarr stores edge
    chunks), files named `i.0.0...`."""
    arr = np.ascontiguousarray(arr)
    compressor = _zarray_compressor(compressor)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    chunks = [chunk_len] + list(arr.shape[1:])
    meta = {"chunks": chunks, "compressor": compressor,
            "dimension_separator": ".", "dtype": arr.dtype.str,
            "fill_value": 0, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    n = max(1, -(-arr.shape[0] // chunk_len)) if arr.shape[0] else 0
    tail = ".0" * (arr.ndim - 1)
    for i in range(n):
        block = arr[i * chunk_len:(i + 1) * chunk_len]
        if block.shape[0] < chunk_len:
            pad = np.zeros((chunk_len,) + arr.shape[1:], arr.dtype)
            pad[:block.shape[0]] = block
            block = pad
        blob = _encode(block.tobytes(), compressor, arr.itemsize)
        with open(os.path.join(path, f"{i}{tail}"), "wb") as f:
            f.write(blob)


def save_zarr(buffer: ReplayBuffer, path: str, chunk_length: int = -1,
              compressors=None) -> None:
    """The buffer as a zarr v2 group at `path` (data/, meta/episode_ends,
    meta/<key>), in the JAX package's chunking. Every array's compressor is
    checked before anything is written."""
    arrays = []
    for k, v in buffer.data.items():
        v = np.asarray(v)
        t_chunk = chunk_length if chunk_length > 0 else _optimal_chunk_length(
            v.shape, v.dtype)
        arrays.append((f"data/{k}", v, t_chunk, k))
    ends = np.asarray(buffer.episode_ends).astype(np.int64)
    arrays.append(("meta/episode_ends", ends, max(1, len(ends)),
                   "episode_ends"))
    for k, v in buffer.meta.items():
        v = np.asarray(v)
        arrays.append((f"meta/{k}", v, max(1, v.shape[0]), k))
    specs = [_zarray_compressor(_resolve_compressor(compressors, key), name)
             for name, _, _, key in arrays]
    _write_group_meta(path)
    for (name, v, chunk_len, _), spec in zip(arrays, specs):
        _write_array(os.path.join(path, *name.split("/")), v, chunk_len,
                     spec)


class _DirStore:
    """Read access to a zarr tree on disk."""

    def __init__(self, root: str):
        self.root = root

    def read(self, key: str) -> Optional[bytes]:
        p = os.path.join(self.root, key)
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def list(self, prefix: str):
        d = os.path.join(self.root, prefix)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []


class _ZipStore:
    """Read access to a zarr tree inside a zip archive (members relative
    to the tree's root, as shutil.make_archive writes them)."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path)
        self.names = {n.rstrip("/") for n in self.zf.namelist()}

    def read(self, key: str) -> Optional[bytes]:
        return self.zf.read(key) if key in self.names else None

    def list(self, prefix: str):
        base = prefix.rstrip("/") + "/"
        return sorted({n[len(base):].split("/")[0] for n in self.names
                       if n.startswith(base) and len(n) > len(base)})


def _array_meta(store, key: str) -> dict:
    raw = store.read(f"{key}/.zarray")
    if raw is None:
        raise FileNotFoundError(f"no zarr array at {key}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 \
            or meta.get("order", "C") not in ("C", "F") or meta.get("filters"):
        raise ValueError(f"{key}: only C- or F-order zarr v2 arrays without "
                         f"filters are read, got {meta}")
    _zarray_compressor(meta["compressor"], key)
    return meta


def _read_array(store, key: str, rows: Optional[tuple] = None,
                meta: Optional[dict] = None) -> np.ndarray:
    """The array at `key`, or its rows [start, stop) along axis 0 (only the
    chunks holding them are read); each chunk in the array's order."""
    meta = meta or _array_meta(store, key)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    lo, hi = (0, shape[0] if shape else 0) if rows is None else (
        max(0, rows[0]), min(rows[1], shape[0]))
    hi = max(lo, hi)
    out = np.empty(((hi - lo,) + shape[1:]) if shape else (), dtype)
    grid = [max(1, -(-s // c)) if s else 0 for s, c in zip(shape, chunks)]
    if shape:
        grid[0] = range(lo // chunks[0], -(-hi // chunks[0]))
    for idx in itertools.product(*(g if isinstance(g, range) else range(g)
                                   for g in grid)):
        name = sep.join(str(i) for i in idx) if idx else "0"
        blob = store.read(f"{key}/{name}")
        sl = [slice(i * c, min((i + 1) * c, s))
              for i, c, s in zip(idx, chunks, shape)]
        if sl:                       # clip the chunk's rows to [lo, hi)
            sl[0] = slice(max(sl[0].start, lo), min(sl[0].stop, hi))
        src = tuple(slice(s.start - i * c, s.stop - i * c)
                    for s, i, c in zip(sl, idx, chunks))
        dst = tuple([slice(sl[0].start - lo, sl[0].stop - lo)] + sl[1:]) \
            if sl else ()
        if blob is None:            # a chunk never written holds fill_value
            out[dst] = fill
            continue
        raw = _decode(blob, meta["compressor"],
                      math.prod(chunks) * dtype.itemsize)
        block = np.frombuffer(raw, dtype).reshape(
            chunks, order=meta.get("order", "C"))
        out[dst] = block[src]
    return out


def load_zarr(path: str) -> ReplayBuffer:
    """Load a zarr dir or .zip archive written by either package."""
    if path.endswith(".zip") or (os.path.isfile(path)
                                 and zipfile.is_zipfile(path)):
        store = _ZipStore(path)
    else:
        store = _DirStore(path)
    data = {k: _read_array(store, f"data/{k}")
            for k in store.list("data") if not k.startswith(".")}
    meta = {k: _read_array(store, f"meta/{k}")
            for k in store.list("meta") if not k.startswith(".")}
    ends = meta.pop("episode_ends")
    return ReplayBuffer(data=data, episode_ends=ends.astype(np.int64),
                        meta=meta)


# ---------------------------------------------------------------------------
# the live on-disk store
# ---------------------------------------------------------------------------

class _RowsView:
    """numpy-like lazy view of one on-disk array: `shape`, `dtype`, `len`,
    row indexing and slicing read only the chunks they touch."""

    def __init__(self, store: _DirStore, key: str):
        self._store, self._key = store, key
        self._meta = _array_meta(store, key)

    @property
    def shape(self):
        return tuple(self._meta["shape"])

    @property
    def dtype(self):
        return np.dtype(self._meta["dtype"])

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, slice) and idx.step in (None, 1):
            start, stop, _ = idx.indices(len(self))
            return _read_array(self._store, self._key, (start, stop),
                               self._meta)
        if isinstance(idx, (int, np.integer)):
            i = range(len(self))[idx]
            return _read_array(self._store, self._key, (i, i + 1),
                               self._meta)[0]
        return np.asarray(self)[idx]

    def __array__(self, dtype=None, copy=None):
        arr = _read_array(self._store, self._key, meta=self._meta)
        return arr.astype(dtype) if dtype is not None else arr


class ZarrReplayBuffer(ReplayBuffer):
    """Live zarr-backed episodic store: episodes append straight to disk.

    The reference's zarr backend (`create_empty_zarr` + `add_episode`
    resize-and-write) for datasets larger than host RAM, as the JAX
    package's `ZarrReplayBuffer`, in this module's zarr v2 writer: an
    append rewrites each array's `.zarray` with the new shape and writes
    the chunks the episode touches; `drop_episode` shrinks the shapes and
    removes the chunks wholly past the end. An existing store at `path` is
    reopened, not replaced. `data[k]` is a lazy view; `get_episode` and
    `get_steps_slice` read only the chunks they need. compressors: as
    `save_to_path`'s (None: the `disk` preset, blosc zstd-5 with
    bitshuffle, as the JAX store writes); `meta/episode_ends` is
    uncompressed, as the JAX store writes it.
    """

    def __init__(self, path: str, compressors=None, chunk_length: int = -1):
        super().__init__()
        self.path = path
        self._compressors = compressors
        self._chunk_length = chunk_length
        self._dir = _DirStore(path)
        self._keys: list = []
        _write_group_meta(path)
        ends = os.path.join(path, "meta", "episode_ends", ".zarray")
        if os.path.exists(ends):
            self.episode_ends = _read_array(
                self._dir, "meta/episode_ends").astype(np.int64)
            self._keys = [k for k in self._dir.list("data")
                          if not k.startswith(".")]
            self.meta = {k: _read_array(self._dir, f"meta/{k}")
                         for k in self._dir.list("meta")
                         if not k.startswith(".") and k != "episode_ends"}
        else:
            self._flush_meta()
        self._refresh()

    @classmethod
    def create_empty_zarr(cls, path: str, **kw) -> "ZarrReplayBuffer":
        return cls(path, **kw)

    def _refresh(self) -> None:
        self.data = {k: _RowsView(self._dir, f"data/{k}") for k in self._keys}

    def _flush_meta(self) -> None:
        ends = np.asarray(self.episode_ends, np.int64)
        _write_array(os.path.join(self.path, "meta", "episode_ends"), ends,
                     max(1, len(ends)), None)

    def _array_dir(self, k: str) -> str:
        return os.path.join(self.path, "data", k)

    def _set_shape(self, k: str, n_rows: int) -> dict:
        """Rewrite data/k's .zarray with n_rows along axis 0; its meta."""
        meta = _array_meta(self._dir, f"data/{k}")
        meta["shape"] = [n_rows] + meta["shape"][1:]
        with open(os.path.join(self._array_dir(k), ".zarray"), "w") as f:
            json.dump(meta, f)
        return meta

    def add_episode(self, episode: Dict[str, np.ndarray]) -> None:
        lengths = {k: len(v) for k, v in episode.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"episode keys disagree on length: {lengths}")
        t = next(iter(lengths.values()))
        if self._keys and set(episode) != set(self._keys):
            raise ValueError(f"episode keys {set(episode)} != buffer keys "
                             f"{set(self._keys)}")
        start = self.n_steps
        # every array's compressor and row shape checked before a write
        new = {k: _zarray_compressor(_resolve_compressor(self._compressors,
                                                         k), f"data/{k}")
               for k in episode if k not in self._keys}
        for k, v in episode.items():
            if k in new:
                continue
            meta = _array_meta(self._dir, f"data/{k}")
            if tuple(meta["chunks"][1:]) != np.shape(v)[1:] \
                    or np.dtype(meta["dtype"]) != np.asarray(v).dtype:
                raise ValueError(f"data/{k}: episode rows {np.shape(v)[1:]} "
                                 f"{np.asarray(v).dtype} do not match the "
                                 f"store's {meta['chunks'][1:]} "
                                 f"{meta['dtype']}")
        for k, v in episode.items():
            v = np.ascontiguousarray(v)
            if k in new:
                chunk = (self._chunk_length if self._chunk_length > 0 else
                         _optimal_chunk_length(v.shape, v.dtype))
                _write_array(self._array_dir(k), v[:0], chunk, new[k])
                self._keys.append(k)
            meta = self._set_shape(k, start + t)
            comp = _zarray_compressor(meta["compressor"], f"data/{k}")
            order = meta.get("order", "C")
            c = meta["chunks"][0]
            sep = meta.get("dimension_separator", ".")
            tail = f"{sep}0" * (v.ndim - 1)
            for i in range(start // c, -(-(start + t) // c)):
                lo, hi = i * c, (i + 1) * c
                block = np.zeros((c,) + v.shape[1:], v.dtype)
                if lo < start:       # the chunk straddles the last episode
                    block[:start - lo] = _read_array(
                        self._dir, f"data/{k}", (lo, start), meta)
                a, b = max(lo, start), min(hi, start + t)
                block[a - lo:b - lo] = v[a - start:b - start]
                name = os.path.join(self._array_dir(k), f"{i}{tail}")
                os.makedirs(os.path.dirname(name), exist_ok=True)
                blob = _encode(block.tobytes(order=order), comp, v.itemsize)
                with open(name, "wb") as f:
                    f.write(blob)
        self.episode_ends = np.append(self.episode_ends, start + t)
        self._flush_meta()
        self._refresh()

    def drop_episode(self) -> None:
        if self.n_episodes == 0:
            raise IndexError("empty buffer")
        start = 0 if self.n_episodes == 1 else int(self.episode_ends[-2])
        for k in self._keys:
            meta = self._set_shape(k, start)
            c = meta["chunks"][0]
            keep = -(-start // c)
            for name in os.listdir(self._array_dir(k)):
                head = name.split(".")[0]
                if head.isdigit() and int(head) >= keep:
                    path = os.path.join(self._array_dir(k), name)
                    if os.path.isdir(path):     # "/"-separated chunk keys
                        shutil.rmtree(path)
                    else:
                        os.remove(path)
        self.episode_ends = self.episode_ends[:-1]
        self._flush_meta()
        self._refresh()

    def get_episode(self, i: int) -> Dict[str, np.ndarray]:
        start = 0 if i == 0 else int(self.episode_ends[i - 1])
        return self.get_steps_slice(start, int(self.episode_ends[i]))

    def get_steps_slice(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        return {k: v[start:stop] for k, v in self.data.items()}

    def save_meta(self) -> None:
        """Write `meta` (per-episode arrays, e.g. track_seed) to disk."""
        for k, v in self.meta.items():
            v = np.asarray(v)
            _write_array(os.path.join(self.path, "meta", k), v,
                         max(1, v.shape[0]),
                         _resolve_compressor(self._compressors, k))
