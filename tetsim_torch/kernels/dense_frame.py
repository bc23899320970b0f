"""One frame of the dense Neo-Hookean engine as one launch
(``csrc/dense_frame.cu``): B bodies of one mesh in columns, every substep's
predict, colour levels, collide, grab and velocity update.

Replaces no TPU kernel: the JAX package runs the frame as XLA's scan of
one-hot products around ``_solve_level_planes``
(``tetsim_tpu/solvers/dense.py``).  The kernel gathers and scatters each
level's corners by index (``DenseArrays.ids``), a block per body with the
body's positions in shared memory, and gives the bits of the products,
NaN and inf spread included.  ``dense_frame`` launches it on CUDA tensors
and raises on any other; its plain twin is ``solvers/dense.py``'s
``frame_reference`` (the products with ``dense_level_reference`` as the
level solve), which ``solvers.dense.step_frame`` runs on CPU tensors.
``launch_count`` counts the launches, one per frame, and ``form_launches``
the launches of each form.

The form is the host's plan from the body's size (``launch_plan``), not a
fallback: a body of up to 19,370 particles keeps its positions in the
block's shared memory (the shared form, 12 bytes a particle against a
Hopper block's 232,448); a larger one in a global scratch [B, 3, N] that
``dense_frame`` allocates, 12 N B bytes (the global form, no dynamic
shared memory).  Either launch that fails raises; neither retries in the
other form.  Nothing else bounds N but int32 indexing: the kernel holds a
particle id and a thread's particle index in an int, so N must stay below
2^31 - 256; long before that the twin's one-hot, f32 [L, N, 4C], meets
``build_dense_arrays``' ``max_bytes`` gate (2 GB by default, as in the JAX
package).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..params import PhysicsParams
from . import build
from .batch import SMEM_LIMIT, expect, prepared
from .gs_fused import _FrameParams, _frame_params

THREADS = 256  # threads per block, as kThreads in csrc/dense_frame.cu
FLOPS_PER_TET = 421  # one tet's projection, as gs_fused.frame_flops counts it
FLOPS_PER_PARTICLE = 13  # predict and velocity update, per substep

FORMS = ("shared", "global")

launch_count = 0  # launches of the CUDA kernel since import (or reset)
form_launches = dict.fromkeys(FORMS, 0)  # the launches of each form


def smem_bytes(num_particles: int) -> int:
    """The body's three position planes: the shared form's dynamic shared
    memory, and the global form's scratch per body."""
    return 12 * num_particles


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the shared form of the dense frame kernel keeps a body's "
            f"positions in shared memory: {num_particles} particles need "
            f"{need} bytes, a Hopper block has {SMEM_LIMIT} (at most "
            f"{SMEM_LIMIT // 12} particles)")


class LaunchPlan(NamedTuple):
    form: str  # "shared" or "global": where a body's positions live
    blocks: int  # one per body
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block
    scratch_bytes: int  # the global form's planes, all bodies


def launch_plan(num_bodies: int, num_particles: int,
                form: str | None = None) -> LaunchPlan:
    """A frame's launch: a block per body, its positions in shared memory
    where they fit a block, else in a global scratch.  ``form`` forces one
    (``chip_smoke.py`` holds the two against each other); a forced shared
    form that does not fit raises ValueError."""
    if form is None:
        form = "shared" if smem_bytes(num_particles) <= SMEM_LIMIT else "global"
    if form == "shared":
        check_fits(num_particles)
        return LaunchPlan(form, num_bodies, THREADS,
                          smem_bytes(num_particles), 0)
    if form == "global":
        return LaunchPlan(form, num_bodies, THREADS, 0,
                          num_bodies * smem_bytes(num_particles))
    raise ValueError(f"unknown form {form!r}: expected one of {FORMS}")


def frame_flops(arr, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame: ``FLOPS_PER_TET`` per tet
    (valid slot) and ``FLOPS_PER_PARTICLE`` per particle, each substep and
    body (compares, clamps, selects and the data-dependent ground friction
    are not counted)."""
    tets = int((arr.irv != 0).sum())
    return num_bodies * params.num_substeps * (
        FLOPS_PER_TET * tets + FLOPS_PER_PARTICLE * arr.num_particles)


def frame_bytes(arr, num_bodies: int) -> int:
    """Bytes a frame must move: pos and vel read once and pos, prev and vel
    written once (f32 [N, 3] a body each), a grab read per body (id and
    target), the level tables read once."""
    tables = sum(t.numel() * t.element_size()
                 for t in (arr.ids, arr.irp, arr.irv, arr.imc))
    return num_bodies * (5 * 12 * arr.num_particles + 16) + tables


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments declared."""
    lib = build.load("dense_frame")
    if lib.dense_frame_launch.argtypes is None:
        lib.dense_frame_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
            + [_FrameParams, ctypes.c_void_p, ctypes.c_void_p])
        lib.dense_frame_launch.restype = ctypes.c_int
        lib.dense_frame_prepare.argtypes = [ctypes.c_int]
        lib.dense_frame_prepare.restype = ctypes.c_int
        lib.dense_frame_error_string.argtypes = [ctypes.c_int]
        lib.dense_frame_error_string.restype = ctypes.c_char_p
        lib.dense_frame_threads.restype = ctypes.c_int
        if lib.dense_frame_threads() != THREADS:
            raise RuntimeError("csrc/dense_frame.cu kThreads != "
                               "dense_frame.THREADS")
    return lib


def dense_frame(pos, vel, arr, params: PhysicsParams, grab_id, grab_pos, *,
                form: str | None = None):
    """One frame on the card: pos / vel f32 [N, 3, B], grab_id int32 [B] (-1
    inactive), grab_pos f32 [3, B], ``arr`` a ``DenseArrays`` (its tables
    only: the one-hot is the twin's); returns new (pos, prev_pos, vel)
    tensors.  ``form`` forces the launch plan's form (for the card's checks;
    by default ``launch_plan`` picks it).  Raises on tensors
    off CUDA and where a launch fails."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the dense frame kernel runs on CUDA, not {dev}")
    N, _, B = pos.shape
    L, C = arr.irv.shape
    plan = launch_plan(B, N, form)
    f32 = torch.float32
    expect(pos, "pos", f32, (N, 3, B), dev)
    expect(vel, "vel", f32, (N, 3, B), dev)
    expect(grab_id, "grab_id", torch.int32, (B,), dev)
    expect(grab_pos, "grab_pos", f32, (3, B), dev)
    expect(arr.ids, "ids", torch.int32, (L, 4 * C), dev)
    expect(arr.irp, "irp", f32, (L, 9, C), dev)
    expect(arr.irv, "irv", f32, (L, C), dev)
    expect(arr.imc, "imc", f32, (L, 4, C), dev)

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    planes = (torch.empty((B, 3, N), dtype=f32, device=dev)
              if plan.form == "global" else None)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = (0 if plan.form == "global"  # no dynamic shared memory
               else prepared(lib, "dense_frame", dev, N))
        if err == 0:
            err = lib.dense_frame_launch(
                pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
                prev_out.data_ptr(), vel_out.data_ptr(), arr.ids.data_ptr(),
                arr.irp.data_ptr(), arr.irv.data_ptr(), arr.imc.data_ptr(),
                grab_id.data_ptr(), grab_pos.data_ptr(), N, plan.blocks, L, C,
                params.num_substeps, _frame_params(params),
                None if planes is None else planes.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_frame launch ({plan.form} form) failed: "
                           f"{lib.dense_frame_error_string(err).decode()}")
    launch_count += 1
    form_launches[plan.form] += 1
    return pos_out, prev_out, vel_out
