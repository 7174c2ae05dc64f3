"""The port's host library (`data/native.py`, `csrc/window_sampler.cpp`)
against the JAX package's `data/native.py` and the port's numpy plain
versions, on CPU.

Every comparison is exact (np.array_equal): the library performs the
numpy versions' float32 operations in their order (uint8 frames divided
by 255, not multiplied by its reciprocal). The JAX package's native module
gives the same results whether its own library is built (it is not in a
fresh checkout: `make -C csrc`) or it falls back to numpy. Also: the
`WindowDataset.batch` of both packages, two processes building the library
at once, a failed build raising with the compiler's log, and the LZ4 block
decoder on hand-made blocks.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from state_policy_diffusionmodel_tpu.data import dataset as jds
from state_policy_diffusionmodel_tpu.data import native as jnative
from state_policy_diffusionmodel_tpu.data import replay_buffer as jrb
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.data import native
from state_policy_diffusionmodel_torch.data import replay_buffer as trb
from state_policy_diffusionmodel_torch.kernels import build

REPO = pathlib.Path(__file__).resolve().parents[1]


def _source(dtype, rng, T=300, shape=(6, 6, 3)):
    if dtype == np.uint8:
        return rng.integers(0, 256, (T,) + shape, dtype=np.uint8)
    return (rng.normal(size=(T,) + shape) * 40).astype(np.float32)


@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gather_equals_jax_and_numpy(dtype, step):
    rng = np.random.default_rng(step)
    src = _source(dtype, rng)
    seq = 8
    starts = rng.integers(0, len(src) - (seq - 1) * step, size=37)
    got = native.gather_windows(src, starts, seq, step)
    assert got.dtype == np.float32 and got.shape == (37, seq, 6, 6, 3)
    assert np.array_equal(got, tds.gather_windows(src, starts, seq, step))
    assert np.array_equal(got, jnative.gather_windows(src, starts, seq, step))
    if dtype == np.uint8:
        # every byte value: x / 255 and x * (1 / 255) differ on about half
        values = np.arange(256, dtype=np.uint8)[:, None]
        got = native.gather_windows(values, np.array([0]), 256, 1)
        assert np.array_equal(got[0], values.astype(np.float32) / 255.0)


@pytest.mark.parametrize("step", [1, 5])
def test_normalize_positions_equals_jax_and_numpy(step):
    rng = np.random.default_rng(10 + step)
    pos = np.cumsum(rng.normal(size=(400, 2)), 0).astype(np.float32) * 30
    starts = rng.integers(0, len(pos) - 39 * step, size=64)
    windows = native.gather_windows(pos, starts, 40, step)
    stats = tds.WindowDataset((
        {"position": pos, "velocity": pos, "action": pos[:, :1].repeat(3, 1),
         "img": np.zeros((len(pos), 2, 2, 3), np.float32)},
        np.array([len(pos)])), 10, 30, step).stats
    lo, hi = (float(stats["position"][k]) for k in ("min", "max"))
    before = windows.copy()
    got = native.normalize_positions(windows, lo, hi)
    assert np.array_equal(windows, before)          # the input is kept
    for want in (tds.normalize_positions(windows, lo, hi),
                 jnative.normalize_positions(windows, lo, hi)):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # a zero range divides by 1, as the numpy version does
    got = native.normalize_positions(windows, 3.0, 3.0)
    want = tds.normalize_positions(windows, 3.0, 3.0)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_window_dataset_batch_equals_jax():
    rng = np.random.default_rng(3)
    data = {
        "img": rng.integers(0, 256, (250, 96, 96, 3), dtype=np.uint8),
        "position": np.cumsum(rng.normal(size=(250, 2)), 0)
        .astype(np.float32) * 20,
        "velocity": rng.normal(size=(250, 2)).astype(np.float32),
        "action": rng.uniform(-1, 1, (250, 3)).astype(np.float32)}
    ends = np.array([130, 250], np.int64)
    tbuf = trb.ReplayBuffer({k: v.copy() for k, v in data.items()}, ends)
    jbuf = jrb.ReplayBuffer({k: v.copy() for k, v in data.items()}, ends)
    tds_ = tds.WindowDataset(tbuf, 4, 6, 5)
    jds_ = jds.WindowDataset(jbuf, 4, 6, 5)
    idx = rng.permutation(len(tds_))[:9]
    got, got_t = tds_.batch(idx, return_translations=True)
    want, want_t = jds_.batch(idx, return_translations=True)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    assert np.array_equal(got_t, np.asarray(want_t))
    # the first image frames only: the same rows
    part = tds_.batch(idx, image_frames=4)["image"]
    assert np.array_equal(part, got["image"][:, :4])


def test_concurrent_builds_both_load(tmp_path):
    """Two processes build the library into an empty build directory at
    the same moment: each writes under its own name and renames into
    place, so both load a whole library and one library is left."""
    code = (
        "import sys, pathlib, numpy as np\n"
        "from state_policy_diffusionmodel_torch.kernels import build\n"
        "build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "from state_policy_diffusionmodel_torch.data import native\n"
        "src = np.arange(60, dtype=np.float32).reshape(20, 3)\n"
        "out = native.gather_windows(src, np.array([2, 5]), 4, 3)\n"
        "print(float(out.sum()))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = float(tds.gather_windows(np.arange(60, dtype=np.float32)
                                    .reshape(20, 3), np.array([2, 5]), 4, 3)
                 .sum())
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert float(out.strip()) == want
    names = sorted(p.name for p in tmp_path.iterdir())
    assert [os.path.splitext(n)[1] for n in names] == [".log", ".so"], names


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    fake = tmp_path / "cxx"
    fake.write_text(f"#!{sys.executable}\n"
                    "print('window_sampler.cpp:1: error: no such thing')\n"
                    "raise SystemExit(1)\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "cxx", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_built", {})
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="error: no such thing"):
        native.library()


def test_lz4_block_decoder():
    # literals only
    assert native.lz4_decompress(b"\x50hello", 5) == b"hello"
    # three literals, then a 9-byte match at offset 3 overlapping itself
    assert native.lz4_decompress(b"\x35abc\x03\x00", 12) == b"abc" * 4
    # 20 literals (15 + 5 in an extension byte), a 4-byte match at offset
    # 20, then 4 more literals
    lits = bytes(range(65, 85))
    block = b"\xf0\x05" + lits + b"\x14\x00" + b"\x40WXYZ"
    assert native.lz4_decompress(block, 28) == lits + lits[:4] + b"WXYZ"
    for bad, size in ((b"\x35abc\x00\x00", 12),     # offset 0
                      (b"\x35abc\x09\x00", 12),     # before the output
                      (b"\x50hel", 5),              # literals cut short
                      (b"\x50hello", 4)):           # more than the room
        with pytest.raises(ValueError, match="LZ4 block"):
            native.lz4_decompress(bad, size)
