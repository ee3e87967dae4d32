"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

A source under csrc/ compiles into a shared library with a plain C
interface, in _build/ next to the package, at first use. The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. No PyTorch headers are
included, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
# per-source build record: (seconds, compiler output); absent when loaded
# from an earlier build
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _lib_path(source: str) -> str:
    path = os.path.join(CSRC, source)
    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _build(source: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_log[source] = (time.perf_counter() - t0, proc.stdout)


def load(source: str) -> ctypes.CDLL:
    """The loaded library for csrc/<source>, built first if needed. A lock
    per source in the build directory lets one process build it while the
    others (the ranks of a data-parallel run) wait for its library, and
    lets two sources build at once."""
    if source not in _loaded:
        out = _lib_path(source)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            stem = os.path.splitext(source)[0]
            with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(out):
                    _build(source, out)
        _loaded[source] = ctypes.CDLL(out)
    return _loaded[source]
