"""Named host ranges on the profiler's timeline.

``span(NAME)`` opens a profiler range named ``NAME`` while a
``torch.profiler`` session records (``diag.trace``, or the caller's own
session), and is one shared null context otherwise: with no session it
costs a function call and a flag test.  Kineto puts these ranges on the
clock of the card's kernel and copy events, and ties each launch made
inside one to it, so a trace tells which host call enqueued a device op
and which one the card waited on while it idled.

The names are constants, made once at import, so a span formats no
string:

    tetsim.world.step           World.step
    tetsim.body.step_export     each body's step_many_export (a viewer frame)
    tetsim.grab.start / .move / .end
                                each body's grab calls (a start reads the
                                grabbed id back: a sync)
    tetsim.kernel.<module>      the frame or substep entry of each kernel
                                module of ``kernels/`` (on CUDA the wrapper's
                                host path through the launch; on the CPU the
                                plain twin)
    tetsim.export               the surface export, parent of
    tetsim.export.positions     its positions (a packed body's layout copy)
    tetsim.export.skin          skinning
    tetsim.export.normals       smooth or rotated normals
    tetsim.build                a native library's compiler run (not a
                                cache hit)
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "tetsim."

WORLD_STEP = PREFIX + "world.step"
STEP_EXPORT = PREFIX + "body.step_export"
GRAB_START = PREFIX + "grab.start"
GRAB_MOVE = PREFIX + "grab.move"
GRAB_END = PREFIX + "grab.end"
EXPORT = PREFIX + "export"
EXPORT_POSITIONS = EXPORT + ".positions"
EXPORT_SKIN = EXPORT + ".skin"
EXPORT_NORMALS = EXPORT + ".normals"
BUILD = PREFIX + "build"
KERNEL = PREFIX + "kernel"

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def kernel(module: str) -> str:
    """The span name of a kernel module's entry, from its ``__name__``."""
    return f"{KERNEL}.{module.rsplit('.', 1)[-1]}"


def span(name: str):
    """A profiler range named ``name`` while a session records, else a
    shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
