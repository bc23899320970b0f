"""Where the port finds the shared files and puts what it compiles.

The port reads one framework-neutral file of the JAX package by path (the
dragon asset) and never imports that package; its native sources are its
own (``csrc/``, ``kernels/csrc/``).  Native code is compiled at first use
into ``tetsim_torch/_build/``, one file per hash of the source and the
headers it includes, so an edited source or header is rebuilt and
concurrent processes never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import re
import subprocess
import tempfile
from typing import Callable, Sequence

from .spans import BUILD, span

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
TPU_PKG_DIR = os.path.join(os.path.dirname(PKG_DIR), "tetsim_tpu")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def source_digest(src: str, tag: str = "") -> str:
    """Hash of ``src``, of every header it includes with quotes (found next
    to the including file, recursively) and of ``tag``."""
    h = hashlib.sha1()
    seen = set()

    def add(path):
        path = os.path.abspath(path)
        if path in seen:
            return
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(text)
        for name in _INCLUDE.findall(text):
            add(os.path.join(os.path.dirname(path), name.decode()))

    add(src)
    h.update(tag.encode())
    return h.hexdigest()[:12]


def compiled_library(
    src: str,
    stem: str,
    command: Callable[[str, str], Sequence[str]],
    tag: str = "",
    timeout: float = 600.0,
) -> str:
    """Path of the shared library built from ``src``, compiling it if absent.

    ``command(src, out)`` gives the compiler's argument list.  The file name
    carries ``source_digest(src, tag)`` (``tag`` for flags or the CPU), and
    the library is written under a temporary name and renamed into place.
    A compiler run is the ``tetsim.build`` span of a profiled process.
    """
    out = os.path.join(BUILD_DIR, f"{stem}_{source_digest(src, tag)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with span(BUILD):
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
