"""Where the port finds the shared files and puts what it compiles.

The port reads the framework-neutral files of the JAX package by path (the
dragon asset, the C++ colouring source) and never imports that package.
Native code is compiled at first use into ``tetsim_torch/_build/``, one
file per source hash, so an edited source is rebuilt and concurrent
processes never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Callable, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
TPU_PKG_DIR = os.path.join(os.path.dirname(PKG_DIR), "tetsim_tpu")


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def compiled_library(
    src: str,
    stem: str,
    command: Callable[[str, str], Sequence[str]],
    tag: str = "",
    timeout: float = 600.0,
) -> str:
    """Path of the shared library built from ``src``, compiling it if absent.

    ``command(src, out)`` gives the compiler's argument list.  The file name
    carries a hash of the source and of ``tag`` (for flags or the CPU), and
    the library is written under a temporary name and renamed into place.
    """
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + tag.encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            list(command(src, tmp)), capture_output=True, text=True,
            timeout=timeout,
        )
        if proc.returncode != 0:
            raise BuildError(
                f"building {os.path.basename(src)} failed "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
