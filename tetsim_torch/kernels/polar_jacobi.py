"""Polar shape-matching frames of one body too large for one block's shared
memory, two launches per substep (``csrc/polar_jacobi.cu``).

Replaces no TPU kernel: for such a body the JAX package runs its XLA
engine (``tetsim_tpu/solvers/polar.py``).  The port's fused frame kernel
(``polar_fused``, K2) keeps a body in one block's shared memory, at most
6,456 particles (``polar_fused.check_fits``); ``Body(engine="polar")`` on
the card runs this module above that.  What bounds it on the card: the
launches and the tet pass's dependent extract_rotation chain, with too few
threads per SM at ``grid_mesh(20, 20, 20)``'s 48,000 tets to hide it.

``jacobi_frame`` runs one frame for B bodies of one mesh: on CUDA tensors
the kernels, on CPU tensors ``jacobi_frame_reference``, the plain-torch
frame of ``solvers/polar.py`` (the same twin as K2's).  ``launch_count``
counts the kernel launches.
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
# frame_flops / frame_bytes: the same work as the fused frame kernel's
from .polar_fused import (_PolarParams, _polar_params, frame_bytes,  # noqa: F401
                          frame_flops, polar_frame_reference)

LAUNCHES_PER_SUBSTEP = 2  # as polar_jacobi_launches_per_substep()

launch_count = 0  # kernel launches since import (or reset)


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its arguments
    declared."""
    lib = build.load("polar_jacobi")
    if lib.polar_jacobi_launch.argtypes is None:
        lib.polar_jacobi_launch.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
            + [_PolarParams, ctypes.c_void_p]
        )
        lib.polar_jacobi_launch.restype = ctypes.c_int
        lib.polar_jacobi_error_string.argtypes = [ctypes.c_int]
        lib.polar_jacobi_error_string.restype = ctypes.c_char_p
        lib.polar_jacobi_launches_per_substep.restype = ctypes.c_int
        if lib.polar_jacobi_launches_per_substep() != LAUNCHES_PER_SUBSTEP:
            raise RuntimeError("csrc/polar_jacobi.cu launches per substep != "
                               "polar_jacobi.LAUNCHES_PER_SUBSTEP")
    return lib


def _jacobi_frame_cuda(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                       grab_id, grab_pos):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the polar Jacobi kernels run on CUDA, not {dev}")
    if arr.inc_idx is None:
        raise ValueError("the polar Jacobi kernels need the incidence tables "
                         "(build_arrays(..., coloring=None))")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N, M = pos.shape[0], arr.num_particles, arr.num_tets
    K = arr.inc_idx.shape[1]
    G = grab_id.shape[-1]
    f32 = torch.float32
    expect(pos, "pos", f32, (B, N, 3), dev)
    expect(vel, "vel", f32, (B, N, 3), dev)
    expect(quats, "quats", f32, (B, M, 4), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    expect(arr.tets, "tets", torch.int32, (M, 4), dev)
    expect(arr.rest_centered, "rest_centered", f32, (M, 4, 3), dev)
    expect(arr.rest_volume, "rest_volume", f32, (M,), dev)
    expect(arr.inv_mass, "inv_mass", f32, (N,), dev)
    expect(arr.inc_idx, "inc_idx", torch.int32, (N, K), dev)
    expect(arr.inc_den, "inc_den", f32, (N,), dev)
    for t in (quats, arr.tets):  # read as float4 / int4
        if t.data_ptr() % 16:
            raise ValueError("quats and tets must be 16-byte aligned")

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    quat_out = torch.empty_like(quats)
    delta = torch.empty((B, 4 * M, 4), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launches go to the current device
        err = lib.polar_jacobi_launch(
            pos.data_ptr(), vel.data_ptr(), quats.data_ptr(),
            pos_out.data_ptr(), prev_out.data_ptr(), vel_out.data_ptr(),
            quat_out.data_ptr(), delta.data_ptr(), arr.tets.data_ptr(),
            arr.rest_centered.data_ptr(), arr.rest_volume.data_ptr(),
            arr.inv_mass.data_ptr(), arr.inc_idx.data_ptr(),
            arr.inc_den.data_ptr(), grab_id.data_ptr(), grab_pos.data_ptr(),
            B, N, M, K, G, S, params.extract_iters, _polar_params(params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("polar_jacobi launch failed: "
                           f"{lib.polar_jacobi_error_string(err).decode()}")
    launch_count += LAUNCHES_PER_SUBSTEP * S
    return pos_out, prev_out, vel_out, quat_out


jacobi_frame_reference = polar_frame_reference


def jacobi_frame(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                 grab_id, grab_pos):
    """One frame for B bodies: pos/vel [B,N,3], quats [B,M,4], grab_id
    int32 [B,G], grab_pos [B,G,3]; returns (pos, prev_pos, vel, quats).
    CPU tensors take the plain path; any other device launches the CUDA
    kernels or raises."""
    if pos.device.type == "cpu":
        return jacobi_frame_reference(pos, vel, quats, arr, params, grab_id,
                                      grab_pos)
    return _jacobi_frame_cuda(pos, vel, quats, arr, params, grab_id, grab_pos)


def step_frame(state: SimState, arr: TetArrays, params: PhysicsParams,
               controls: Controls):
    """One frame of one body through ``jacobi_frame`` (engine API).
    Returns (state, vol_errs [num_substeps] of zeros)."""
    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, quats = jacobi_frame(
        state.pos[None], state.vel[None], state.quats[None], arr, params,
        gid[None], gpos[None])
    return (state.replace(pos=pos[0], prev_pos=prev_pos[0], vel=vel[0],
                          quats=quats[0]),
            pos.new_zeros((params.num_substeps,)))
