"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under `state_policy_diffusionmodel_torch/csrc/` has a plain C
interface (no PyTorch headers), so one `nvcc` call turns it into a shared
library in seconds. Libraries go to `build/` at the repository root, named
by a hash of the source, every shared header (`csrc/*.cuh`) and the flags,
so an edited source or header builds anew and an unchanged one is loaded as
it is; nvcc's log is kept beside each library (`.log`) and read back with
it. Nothing is built when this module is imported: the first call that
needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel source of the port, by library name
SOURCES = {"attention_core": "attention_core.cu",
           "sample_banked": "sample_banked.cu",
           "conv3x3": "conv3x3.cu",
           "gn_act": "gn_act.cu",
           "conv_dw": "conv_dw.cu"}


@dataclass
class Built:
    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    log: str            # nvcc's output (ptxas register and spill report),
                        # also when the library was cached


_built: dict[str, Built] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    """The library's path in build/: its name and a hash of its source, of
    every header a source may include, and of the flags."""
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Built]:
    """Build the named libraries (all by default), one nvcc per source, all
    started together. Returns what was built or found, by name."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _built:
            continue
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            _built[name] = Built(name, out, 0.0,
                                 log.read_text() if log.exists() else "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)
        _built[name] = Built(name, out, seconds, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: _built[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is not in build/."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all([name])[name].path))
    return _libs[name]
