"""Build the port's CUDA kernels with nvcc, and its host library with g++,
and load them through ctypes.

Each source under `state_policy_diffusionmodel_torch/csrc/` has a plain C
interface (no PyTorch headers), so one compiler call turns it into a shared
library in seconds: `nvcc` for the kernels (`SOURCES`), the host C++
compiler for the host libraries (`HOST_SOURCES`: the window gather and the
blosc codecs' decoders, and the blosc codecs' encoders). Libraries go to
`build/` at the repository root, named by a hash of the source, of every
shared header (`csrc/*.cuh` for the kernels, `csrc/*.h` for the host
libraries) and of the flags, so an edited source or header builds anew and
an unchanged one is loaded as it is; the compiler's log is kept beside each
library (`.log`) and read back with it. A library is written under a name
of its own process and renamed into place, so processes that build the
same library at once each load a whole one. Nothing is built when this
module is imported: the first call that needs a library builds it.
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

# host C++ (no CUDA), by library name. No -march=native: the library must
# give the numpy versions' float32 results, which FMA contraction would
# change, and build/ may be shared by hosts of different CPUs
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
HOST_SOURCES = {"window_sampler": "window_sampler.cpp",
                "blosc_codec": "blosc_codec.cpp"}


@dataclass
class Built:
    name: str
    path: Path
    seconds: float      # the compiler's wall time; 0.0 when the library
                        # was cached
    log: str            # the compiler's output (nvcc's ptxas register and
                        # spill report), also when the library was cached


_built: dict[str, Built] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++ or c++ on the PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand:
            return cand
    raise RuntimeError("no host C++ compiler found: set CXX (g++ works)")


def _source(name: str) -> Path:
    return CSRC_DIR / (SOURCES[name] if name in SOURCES
                       else HOST_SOURCES[name])


def _target(name: str) -> Path:
    """The library's path in build/: its name and a hash of its source, of
    every header it may include (`csrc/*.cuh` for a kernel, `csrc/*.h` for
    the host library), and of the flags."""
    h = hashlib.sha256(_source(name).read_bytes())
    if name in SOURCES:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        for header in sorted(CSRC_DIR.glob("*.h")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in SOURCES:
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]
    return [cxx(), *HOST_FLAGS, "-o", str(out), str(_source(name))]


def build_all(names=None) -> dict[str, Built]:
    """Build the named libraries (every kernel and the host library by
    default), one compiler per source, all started together. Returns what
    was built or found, by name."""
    names = list([*SOURCES, *HOST_SOURCES] if names is None else names)
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
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} ({os.path.basename(proc.args[0])} exit "
                          f"{proc.returncode}):\n{log}")
            continue
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)
        _built[name] = Built(name, out, seconds, log)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return {n: _built[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is not in build/; a
    library that does not load raises with its build log."""
    if name not in _libs:
        built = build_all([name])[name]
        try:
            _libs[name] = ctypes.CDLL(str(built.path))
        except OSError as e:
            raise RuntimeError(f"{built.path} does not load ({e}); its build "
                               f"log:\n{built.log}") from e
    return _libs[name]
