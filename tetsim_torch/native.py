"""Native (C++) mesh-preprocessing kernels, loaded over ctypes.

Counterpart of ``tetsim_tpu/native/__init__.py``.  The source is the port's
own ``csrc/coloring.cpp`` (a copy of the JAX package's), compiled with g++
into the port's build directory on first use.  This is host preprocessing:
when no C++ toolchain is available the callers in ``mesh.py`` fall back to
the pure-Python implementations, which compute the same tables.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import threading
from typing import Optional

import numpy as np

from ._compile import PKG_DIR, BuildError, compiled_library

_SRC = os.path.join(PKG_DIR, "csrc", "coloring.cpp")


def _cpu_tag() -> str:
    """Machine arch + a hash of the CPU feature flags: the build uses
    -march=native, so a library built on another CPU must not be loaded."""
    tag = platform.machine().lower()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return f"{tag}_{hashlib.sha1(flags.encode()).hexdigest()[:8]}"
    except OSError:
        pass
    return tag


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _gxx(src: str, out: str):
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            src, "-o", out]


def load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = compiled_library(
                _SRC, "libtetsim_native", _gxx, tag=_cpu_tag(), timeout=120
            )
            lib = ctypes.CDLL(path)
        except (OSError, BuildError):
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.level_schedule.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.level_schedule.restype = ctypes.c_int
        lib.greedy_color.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.greedy_color.restype = ctypes.c_int
        lib.color_slots.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i64p
        ]
        lib.color_slots.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def level_schedule(tets: np.ndarray, n_particles: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, np.int32)
    out = np.empty(tets.shape[0], np.int32)
    lib.level_schedule(tets, tets.shape[0], n_particles, out)
    return out


def greedy_color(tets: np.ndarray, n_particles: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, np.int32)
    out = np.empty(tets.shape[0], np.int32)
    lib.greedy_color(tets, tets.shape[0], n_particles, out)
    return out


def color_slots(colors: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    colors = np.ascontiguousarray(colors, np.int32)
    m = colors.shape[0]
    if m == 0:
        return np.zeros((0, 0), np.int32)
    num_colors = int(colors.max()) + 1
    cmax_cap = int(np.bincount(colors, minlength=num_colors).max())
    buf = np.empty(num_colors * cmax_cap, np.int32)
    cmax = np.zeros(1, np.int64)
    l = lib.color_slots(colors, m, num_colors, cmax_cap, buf, cmax)
    if l < 0:
        return None
    return buf[: l * cmax[0]].reshape(l, int(cmax[0]))
