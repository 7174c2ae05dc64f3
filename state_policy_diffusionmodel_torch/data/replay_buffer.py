"""Episodic replay buffer and its zarr v2 store, with numpy and the standard
library only.

Counterpart of `state_policy_diffusionmodel_tpu/data/replay_buffer.py`.
`ReplayBuffer` is the same in-memory store: per-key arrays of all frames,
`episode_ends`, and per-episode `meta` arrays. On disk the layout is the
same zarr v2 group, `data/<key>`, `meta/episode_ends`, `meta/<key>` and a
`.zgroup` at each level, so either package reads what the other writes;
a `.zip` of such a directory is read through `zipfile`.

The JAX package writes through tensorstore with blosc by default: zstd-5
with bitshuffle (its `disk` preset) or lz4 (`default`). This module reads
blosc chunks itself (`_blosc_decode`): the chunk header and block offsets,
memcpyed chunks, split streams, zlib through `zlib`, zstd, lz4 and lz4hc
through the port's host library (`data/native.py`: a hand-written zstd
frame decoder and LZ4 block decoder), byte shuffle undone in numpy and
bitshuffle in the host library, one chunk at a time; one path on every
machine. It also
reads arrays without a compressor or with `zlib`. It writes `zlib` (level 1) by
default, or uncompressed, both of which the JAX package's tensorstore reads.

`ZarrReplayBuffer` is the live on-disk store (the JAX package's, there
through tensorstore's resizable zarr driver): episodes append straight to
disk as a resize of each array's `.zarray` shape and a write of the chunks
the episode touches (a chunk that straddles two episodes is read, filled
and rewritten whole), and reads load only the chunks they touch. Where the
JAX store's default compressor is blosc-zstd, this one writes zlib.
"""

from __future__ import annotations

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

DEFAULT_COMPRESSOR = {"id": "zlib", "level": 1}


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
        """compressors: None (zlib level 1 for every key), or a per-key dict
        of zarr compressor specs ({'id': 'zlib', 'level': L} or None);
        keys it does not name take zlib level 1."""
        save_zarr(self, path, chunk_length=chunk_length,
                  compressors=compressors)
        if make_zip:
            shutil.make_archive(path, "zip", path)


# ---------------------------------------------------------------------------
# zarr v2 arrays: .zarray JSON + one file per chunk, C order
# ---------------------------------------------------------------------------

def _resolve_compressor(compressors, key: str) -> Optional[dict]:
    if compressors is None:
        return DEFAULT_COMPRESSOR
    if isinstance(compressors, dict) and (
            not compressors or "id" not in compressors):
        return compressors.get(key, DEFAULT_COMPRESSOR)
    raise ValueError(f"compressors must be None or a per-key dict, got "
                     f"{compressors!r}")


def _encode(raw: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return raw
    if compressor.get("id") == "zlib":
        return zlib.compress(raw, int(compressor.get("level", 1)))
    raise ValueError(f"cannot write zarr compressor {compressor!r}: this "
                     "package writes uncompressed and zlib arrays only")


# blosc1's compressor format codes (the header's flags >> 5)
_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_BLOSC_READ = {"lz4", "lz4hc", "zlib", "zstd"}


def _check_codec(compressor: Optional[dict], where: str) -> None:
    """Raise, naming what is missing, unless this machine reads the codec."""
    cid = None if compressor is None else compressor.get("id")
    if cid in (None, "zlib"):
        return
    if cid == "blosc":
        cname = compressor.get("cname")
        if cname not in _BLOSC_READ:
            raise ValueError(f"{where} is compressed with blosc {cname}: "
                             f"this package reads blosc "
                             f"{sorted(_BLOSC_READ)} only")
        return
    raise ValueError(f"{where} is compressed with {cid}: this package reads "
                     "uncompressed, zlib and blosc zarr arrays only")


def _blosc_stream(data: bytes, codec: str, size: int) -> bytes:
    """One compressed blosc stream decoded to its `size` bytes."""
    if codec == "lz4":
        return native.lz4_decompress(data, size)
    if codec == "zstd":
        return native.zstd_decompress(data, size)
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
    where n streams of at most bsize // n bytes do not fill it exactly."""
    if bsize % n:
        return None
    pos, parts = lo, []
    for _ in range(n):
        if pos + 4 > hi:
            return None
        c = int(np.frombuffer(blob, "<i4", 1, pos)[0])
        pos += 4
        if c <= 0 or c > bsize // n or pos + c > hi:
            return None
        parts.append(blob[pos:pos + c])
        pos += c
    return parts if pos == hi else None


def _decode(blob: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return blob
    if compressor.get("id") == "blosc":
        return _blosc_decode(blob)
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
        with open(os.path.join(path, f"{i}{tail}"), "wb") as f:
            f.write(_encode(block.tobytes(), compressor))


def save_zarr(buffer: ReplayBuffer, path: str, chunk_length: int = -1,
              compressors=None) -> None:
    """The buffer as a zarr v2 group at `path` (data/, meta/episode_ends,
    meta/<key>), in the JAX package's chunking."""
    _write_group_meta(path)
    for k, v in buffer.data.items():
        v = np.asarray(v)
        t_chunk = chunk_length if chunk_length > 0 else _optimal_chunk_length(
            v.shape, v.dtype)
        _write_array(os.path.join(path, "data", k), v, t_chunk,
                     _resolve_compressor(compressors, k))
    ends = np.asarray(buffer.episode_ends).astype(np.int64)
    _write_array(os.path.join(path, "meta", "episode_ends"), ends,
                 max(1, len(ends)),
                 _resolve_compressor(compressors, "episode_ends"))
    for k, v in buffer.meta.items():
        v = np.asarray(v)
        _write_array(os.path.join(path, "meta", k), v, max(1, v.shape[0]),
                     _resolve_compressor(compressors, k))


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
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise ValueError(f"{key}: only C-order zarr v2 arrays without "
                         f"filters are read, got {meta}")
    _check_codec(meta["compressor"], key)
    return meta


def _read_array(store, key: str, rows: Optional[tuple] = None,
                meta: Optional[dict] = None) -> np.ndarray:
    """The array at `key`, or its rows [start, stop) along axis 0 (only the
    chunks holding them are read)."""
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
        block = np.frombuffer(_decode(blob, meta["compressor"]),
                              dtype).reshape(chunks)
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
    `get_steps_slice` read only the chunks they need. compressors: None
    (zlib level 1 for every key) or a per-key dict ({'id': 'zlib',
    'level': L} or None); `meta/episode_ends` is uncompressed, as the JAX
    store writes it.
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
        for k, v in episode.items():
            v = np.ascontiguousarray(v)
            if k not in self._keys:
                chunk = (self._chunk_length if self._chunk_length > 0 else
                         _optimal_chunk_length(v.shape, v.dtype))
                _write_array(self._array_dir(k), v[:0], chunk,
                             _resolve_compressor(self._compressors, k))
                self._keys.append(k)
            meta = self._set_shape(k, start + t)
            c = meta["chunks"][0]
            if tuple(meta["chunks"][1:]) != v.shape[1:] \
                    or np.dtype(meta["dtype"]) != v.dtype:
                raise ValueError(f"data/{k}: episode rows {v.shape[1:]} "
                                 f"{v.dtype} do not match the store's "
                                 f"{meta['chunks'][1:]} {meta['dtype']}")
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
                with open(name, "wb") as f:
                    f.write(_encode(block.tobytes(), meta["compressor"]))
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
