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
``launch_count`` counts the launches, one per frame.
"""
from __future__ import annotations

import ctypes

import torch

from ..params import PhysicsParams
from . import build
from .batch import SMEM_LIMIT, expect, prepared
from .gs_fused import _FrameParams, _frame_params

THREADS = 256  # threads per block, as kThreads in csrc/dense_frame.cu
FLOPS_PER_TET = 421  # one tet's projection, as gs_fused.frame_flops counts it
FLOPS_PER_PARTICLE = 13  # predict and velocity update, per substep

launch_count = 0  # launches of the CUDA kernel since import (or reset)


def smem_bytes(num_particles: int) -> int:
    """Shared memory of one block: the body's three position planes."""
    return 12 * num_particles


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the dense frame kernel keeps a body's positions in shared "
            f"memory: {num_particles} particles need {need} bytes, a Hopper "
            f"block has {SMEM_LIMIT} (at most {SMEM_LIMIT // 12} particles)")


def launch_plan(num_bodies: int, num_particles: int) -> tuple[int, int, int]:
    """(blocks, threads per block, dynamic shared bytes) of a frame: a block
    per body, the body's positions in shared memory; raises ValueError where
    they pass a block's limit."""
    check_fits(num_particles)
    return num_bodies, THREADS, smem_bytes(num_particles)


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
            + [_FrameParams, ctypes.c_void_p])
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


def dense_frame(pos, vel, arr, params: PhysicsParams, grab_id, grab_pos):
    """One frame on the card: pos / vel f32 [N, 3, B], grab_id int32 [B] (-1
    inactive), grab_pos f32 [3, B], ``arr`` a ``DenseArrays``; returns new
    (pos, prev_pos, vel) tensors.  Raises on tensors off CUDA and where a
    body's positions pass a block's shared memory."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the dense frame kernel runs on CUDA, not {dev}")
    N, _, B = pos.shape
    L, C = arr.irv.shape
    blocks, _, _ = launch_plan(B, N)
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
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = prepared(lib, "dense_frame", dev, N)
        if err == 0:
            err = lib.dense_frame_launch(
                pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
                prev_out.data_ptr(), vel_out.data_ptr(), arr.ids.data_ptr(),
                arr.irp.data_ptr(), arr.irv.data_ptr(), arr.imc.data_ptr(),
                grab_id.data_ptr(), grab_pos.data_ptr(), N, blocks, L, C,
                params.num_substeps, _frame_params(params),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("dense_frame launch failed: "
                           f"{lib.dense_frame_error_string(err).decode()}")
    launch_count += 1
    return pos_out, prev_out, vel_out
