"""Builds the CUDA kernels of ``kernels/csrc`` and loads them over ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
nvcc for Hopper (``sm_90a``) into a shared library in
``tetsim_torch/_build/``, at first use and again whenever the source or a
header it includes (``csrc/*.cuh``) changes.  A failed build raises with
the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

from .._compile import BuildError, compiled_library

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards _locks
_locks: dict[tuple, threading.Lock] = {}  # one per library: builds run in parallel
_libs: dict[tuple, ctypes.CDLL] = {}  # by (name, flags)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load(name: str, flags: tuple = ()) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` with ``NVCC_FLAGS`` and the
    kernel's own ``flags``, compiled if needed.  Each set of flags is a
    library of its own; calls for different libraries from different
    threads compile concurrently."""
    key = (name, tuple(flags))
    with _lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _libs:
            args = (*NVCC_FLAGS, *flags)
            path = compiled_library(
                os.path.join(CSRC, f"{name}.cu"), f"lib{name}",
                lambda src, out: [nvcc(), *args, src, "-o", out],
                tag=" ".join(args),
            )
            _libs[key] = ctypes.CDLL(path)
        return _libs[key]
