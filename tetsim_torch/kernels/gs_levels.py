"""Neo-Hookean Gauss-Seidel frames of one body too large for one block's
shared memory, a whole frame per launch on a thread-block cluster
(``csrc/gs_levels.cu``).

Replaces no TPU kernel: for such a body the JAX package runs its XLA
engine (``tetsim_tpu/solvers/neohookean.py``).  The port's fused frame
kernel (``gs_fused``, K1) keeps a body in one block's shared memory, at most
6,456 particles (``gs_fused.check_fits``); ``Body(engine="neohookean")``
on the card runs this module above that.  Each body runs on a cluster of
``cs`` blocks (``polar_fused.cluster_size`` over this kernel's
``active_clusters``), which walk the ordered levels with a cluster barrier
between them, the positions in global memory; ``level_plan`` says which
block, thread and pass take each slot of a level.

``levels_frame`` runs one frame for B bodies of one mesh: on CUDA tensors
the kernel, on CPU tensors ``levels_frame_reference``, the plain-torch
frame of ``solvers/neohookean.py`` (the same twin as K1's).
``launch_count`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..solvers import common
from ..state import Controls, SimState
from ..spans import kernel, span
from . import build
from .batch import expect
from .gs_fused import _FrameParams, _frame_params, gs_frame_reference
from .polar_fused import CLUSTER_SIZES, MAX_CLUSTER, cluster_size, split

THREADS = 256  # threads per block and slots per volume sum (kThreads)
LAUNCHES_PER_FRAME = 1  # as gs_levels_launches_per_frame()
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


def level_plan(num_slots: int, cs: int) -> list:
    """How a cluster of ``cs`` blocks takes a level of ``num_slots`` slots,
    as ``gs_levels_frame_kernel`` walks it: (block rank, thread, pass,
    slot) for every slot.  Block r takes the slots ``polar_fused.split``
    gives it, ceil(num_slots / cs) in a row, thread j its j-th, then j +
    THREADS-th in the next pass, and so on."""
    return [(r, j % THREADS, j // THREADS, slot)
            for r, (lo, hi) in enumerate(split(num_slots, cs))
            for j, slot in enumerate(range(lo, hi))]


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
    """The kernel's library, built at first use, with its arguments
    declared."""
    lib = build.load("gs_levels", NVCC_FLAGS)
    if lib.gs_levels_launch.argtypes is None:
        lib.gs_levels_launch.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
            + [_FrameParams, ctypes.c_void_p]
        )
        lib.gs_levels_launch.restype = ctypes.c_int
        lib.gs_levels_prepare.restype = ctypes.c_int
        lib.gs_levels_active_clusters.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.gs_levels_active_clusters.restype = ctypes.c_int
        lib.gs_levels_error_string.argtypes = [ctypes.c_int]
        lib.gs_levels_error_string.restype = ctypes.c_char_p
        lib.gs_levels_threads.restype = ctypes.c_int
        lib.gs_levels_launches_per_frame.restype = ctypes.c_int
        if (lib.gs_levels_threads() != THREADS
                or lib.gs_levels_launches_per_frame() != LAUNCHES_PER_FRAME):
            raise RuntimeError("csrc/gs_levels.cu kThreads / launches per "
                               "frame != gs_levels.THREADS / "
                               "LAUNCHES_PER_FRAME")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"gs_levels {what} failed: "
                           f"{lib.gs_levels_error_string(err).decode()}")


def active_clusters(device) -> dict:
    """{cs: clusters of cs blocks the card runs at once with one block on
    each SM} for each cluster size (cudaOccupancyMaxActiveClusters on
    ``device``, after the kernel's attributes are set there; 0 where it
    runs none), asked once per device.  Raises on a CUDA error."""
    lib = library()
    waves = lib.__dict__.setdefault("waves", {})
    if device.index not in waves:
        out = {}
        with torch.cuda.device(device):
            _check(lib, lib.gs_levels_prepare(), "prepare")
            for cs in CLUSTER_SIZES:
                count = ctypes.c_int(0)
                _check(lib, lib.gs_levels_active_clusters(
                    cs, ctypes.byref(count)), f"occupancy query at cs={cs}")
                out[cs] = count.value
        waves[device.index] = out
    return waves[device.index]


def _levels_frame_cuda(pos, vel, arr: TetArrays, params: PhysicsParams,
                       grab_id, grab_pos, cs: Optional[int] = None):
    """The launch; ``cs`` overrides ``cluster_size`` so that a check can run
    a narrow cluster."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the level kernel runs on CUDA, not {dev}")
    if arr.slot_tets is None:
        raise ValueError("the level kernel needs a GS schedule "
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
    waves = active_clusters(dev)
    if cs is None:
        cs = cluster_size(B, MAX_CLUSTER, waves)
    elif waves.get(cs, 0) < 1:
        raise ValueError(f"cluster size {cs}: the card runs clusters of "
                         f"{[c for c, n in waves.items() if n >= 1]} blocks")
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    vol_err = torch.empty((B, S), dtype=f32, device=dev)
    pos4 = torch.empty((B, N, 4), dtype=f32, device=dev)  # scratch
    slot_err = torch.empty((B, L, C), dtype=f32, device=dev)
    partial = torch.empty((B, L, -(-C // THREADS)), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.gs_levels_launch(
            pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
            prev_out.data_ptr(), vel_out.data_ptr(), vol_err.data_ptr(),
            pos4.data_ptr(), slot_err.data_ptr(),
            partial.data_ptr(), arr.slot_tets.data_ptr(),
            arr.slot_inv_rest_pose.data_ptr(),
            arr.slot_inv_rest_volume.data_ptr(), arr.slot_inv_mass.data_ptr(),
            arr.slot_valid.data_ptr(), arr.inv_mass.data_ptr(),
            grab_id.data_ptr(), grab_pos.data_ptr(),
            B, cs, N, L, C, G, S, arr.num_tets, _frame_params(params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, err, f"cluster launch (B={B}, cs={cs})")
    launch_count += LAUNCHES_PER_FRAME
    return pos_out, prev_out, vel_out, vol_err


levels_frame_reference = gs_frame_reference


def levels_frame(pos, vel, arr: TetArrays, params: PhysicsParams, grab_id,
                 grab_pos):
    """One frame for B bodies: pos/vel [B,N,3], grab_id int32 [B,G],
    grab_pos [B,G,3]; returns (pos, prev_pos, vel, vol_err [B,
    num_substeps]).  CPU tensors take the plain path; any other device
    launches the CUDA kernels or raises."""
    with span(_SPAN):
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
