"""Neo-Hookean Gauss-Seidel frames of one body too large for one block's
shared memory, a launch per colour level (``csrc/gs_levels.cu``).

Replaces no TPU kernel: for such a body the JAX package runs its XLA
engine (``tetsim_tpu/solvers/neohookean.py``).  The port's fused frame
kernel (``gs_fused``, K1) keeps a body in one block's shared memory, at most
6,456 particles (``gs_fused.check_fits``); ``Body(engine="neohookean")``
on the card runs this module above that.  What bounds it on the card: the
host's launches, L + 2 per substep (80 for ``grid_mesh(20, 20, 20)`` on
the ordered schedule), each a few blocks of a level's tets.

``levels_frame`` runs one frame for B bodies of one mesh: on CUDA tensors
the kernels, on CPU tensors ``levels_frame_reference``, the plain-torch
frame of ``solvers/neohookean.py`` (the same twin as K1's).
``launch_count`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..solvers import common
from ..state import Controls, SimState
from . import build
from .batch import expect
from .gs_fused import _FrameParams, _frame_params, gs_frame_reference

THREADS = 256  # threads per block, as kThreads in csrc/gs_levels.cu

launch_count = 0  # kernel launches since import (or reset)


def launches_per_substep(arr: TetArrays) -> int:
    """Predict, one launch per level, collide."""
    return arr.slot_valid.shape[0] + 2


def frame_flops(arr: TetArrays, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame, counted as for
    ``gs_fused.frame_flops`` (the same tet projection): 421 per valid tet
    and 13 per particle, per substep."""
    m, n = int(arr.slot_valid.sum()), arr.num_particles
    return num_bodies * params.num_substeps * (421 * m + 13 * n)


def frame_bytes(arr: TetArrays, params: PhysicsParams, num_bodies: int,
                num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (pos, vel, a tet's
    slot-table constants at 73 bytes, inv_mass, grabs), each output written
    once (pos, prev, vel, vol_err)."""
    n = arr.num_particles
    tets = int(arr.slot_valid.sum())
    return (num_bodies * (5 * 12 * n + 4 * params.num_substeps
                          + 16 * num_grabs) + 73 * tets + 4 * n)


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its arguments
    declared."""
    lib = build.load("gs_levels")
    if lib.gs_levels_launch.argtypes is None:
        lib.gs_levels_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
            + [_FrameParams, ctypes.c_void_p]
        )
        lib.gs_levels_launch.restype = ctypes.c_int
        lib.gs_levels_error_string.argtypes = [ctypes.c_int]
        lib.gs_levels_error_string.restype = ctypes.c_char_p
        lib.gs_levels_threads.restype = ctypes.c_int
        if lib.gs_levels_threads() != THREADS:
            raise RuntimeError("csrc/gs_levels.cu kThreads != gs_levels.THREADS")
    return lib


def _levels_frame_cuda(pos, vel, arr: TetArrays, params: PhysicsParams,
                       grab_id, grab_pos):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the level kernels run on CUDA, not {dev}")
    if arr.slot_tets is None:
        raise ValueError("the level kernels need a GS schedule "
                         "(build_arrays(..., coloring='ordered'|'greedy'))")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N = pos.shape[0], arr.num_particles
    L, C = arr.slot_valid.shape
    G = grab_id.shape[-1]
    f32 = torch.float32
    expect(pos, "pos", f32, (B, N, 3), dev)
    expect(vel, "vel", f32, (B, N, 3), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    expect(arr.slot_tets, "slot_tets", torch.int32, (L, C, 4), dev)
    expect(arr.slot_inv_rest_pose, "slot_inv_rest_pose", f32, (L, C, 3, 3), dev)
    expect(arr.slot_inv_rest_volume, "slot_inv_rest_volume", f32, (L, C), dev)
    expect(arr.slot_inv_mass, "slot_inv_mass", f32, (L, C, 4), dev)
    expect(arr.slot_valid, "slot_valid", torch.bool, (L, C), dev)
    expect(arr.inv_mass, "inv_mass", f32, (N,), dev)
    for t in (arr.slot_tets, arr.slot_inv_mass):  # read as int4 / float4
        if t.data_ptr() % 16:
            raise ValueError("slot tables must be 16-byte aligned")

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    vol_err = torch.empty((B, S), dtype=f32, device=dev)
    partial = torch.empty((B, L, -(-C // THREADS)), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launches go to the current device
        err = lib.gs_levels_launch(
            pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
            prev_out.data_ptr(), vel_out.data_ptr(), vol_err.data_ptr(),
            partial.data_ptr(), arr.slot_tets.data_ptr(),
            arr.slot_inv_rest_pose.data_ptr(),
            arr.slot_inv_rest_volume.data_ptr(), arr.slot_inv_mass.data_ptr(),
            arr.slot_valid.data_ptr(), arr.inv_mass.data_ptr(),
            grab_id.data_ptr(), grab_pos.data_ptr(),
            B, N, L, C, G, S, arr.num_tets, _frame_params(params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("gs_levels launch failed: "
                           f"{lib.gs_levels_error_string(err).decode()}")
    launch_count += (L + 2) * S
    return pos_out, prev_out, vel_out, vol_err


levels_frame_reference = gs_frame_reference


def levels_frame(pos, vel, arr: TetArrays, params: PhysicsParams, grab_id,
                 grab_pos):
    """One frame for B bodies: pos/vel [B,N,3], grab_id int32 [B,G],
    grab_pos [B,G,3]; returns (pos, prev_pos, vel, vol_err [B,
    num_substeps]).  CPU tensors take the plain path; any other device
    launches the CUDA kernels or raises."""
    if pos.device.type == "cpu":
        return levels_frame_reference(pos, vel, arr, params, grab_id,
                                      grab_pos)
    return _levels_frame_cuda(pos, vel, arr, params, grab_id, grab_pos)


def step_frame(state: SimState, arr: TetArrays, params: PhysicsParams,
               controls: Controls):
    """One frame of one body through ``levels_frame`` (engine API).
    Returns (state, vol_errs [num_substeps])."""
    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, vol_errs = levels_frame(
        state.pos[None], state.vel[None], arr, params, gid[None], gpos[None])
    return state.replace(pos=pos[0], prev_pos=prev_pos[0],
                         vel=vel[0]), vol_errs[0]
