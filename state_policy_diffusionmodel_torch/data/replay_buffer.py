"""Episodic replay buffer and its zarr v2 store, with numpy and the standard
library only.

Counterpart of `state_policy_diffusionmodel_tpu/data/replay_buffer.py`.
`ReplayBuffer` is the same in-memory store: per-key arrays of all frames,
`episode_ends`, and per-episode `meta` arrays. On disk the layout is the
same zarr v2 group, `data/<key>`, `meta/episode_ends`, `meta/<key>` and a
`.zgroup` at each level, so either package reads what the other writes;
a `.zip` of such a directory is read through `zipfile`.

The JAX package writes through tensorstore with blosc by default. This
module has no blosc codec (and the GPU machine has no tensorstore, zarr or
numcodecs): it reads and writes arrays without a compressor or with
`zlib`, and a blosc store raises and names its codec. It writes `zlib`
(level 1) by default, which the JAX package's tensorstore also reads. The
live `ZarrReplayBuffer` is not ported yet.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

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


_READABLE = (None, "zlib")


def _check_codec(compressor: Optional[dict], where: str) -> None:
    cid = None if compressor is None else compressor.get("id")
    if cid in _READABLE:
        return
    detail = (f", cname {compressor.get('cname')}" if cid == "blosc"
              else "")
    raise ValueError(
        f"{where} is compressed with {cid}{detail}: this package reads "
        "uncompressed and zlib zarr stores only, and the GPU machine has no "
        "blosc reader (no numcodecs, zarr or tensorstore). Rewrite the store "
        "with zlib (the JAX package's save_zarr with compressors="
        "{key: {'id': 'zlib', 'level': 1}}), or collect the data on the card")


def _decode(blob: bytes, compressor: Optional[dict]) -> bytes:
    return blob if compressor is None else zlib.decompress(blob)


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


def _read_array(store, key: str) -> np.ndarray:
    raw = store.read(f"{key}/.zarray")
    if raw is None:
        raise FileNotFoundError(f"no zarr array at {key}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise ValueError(f"{key}: only C-order zarr v2 arrays without "
                         f"filters are read, got {meta}")
    _check_codec(meta["compressor"], key)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    out = np.empty(shape, dtype)
    grid = [max(1, -(-s // c)) if s else 0 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        name = sep.join(str(i) for i in idx) if idx else "0"
        blob = store.read(f"{key}/{name}")
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        if blob is None:            # a chunk never written holds fill_value
            out[sl] = fill
            continue
        block = np.frombuffer(_decode(blob, meta["compressor"]),
                              dtype).reshape(chunks)
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
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
