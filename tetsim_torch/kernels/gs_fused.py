"""Fused coloured Gauss-Seidel frame for B bodies of one mesh (counterpart
of ``tetsim_tpu/kernels/gs_fused.py``).

``gs_frame`` runs one whole frame (every substep: predict, every colour
level, collide, grab, velocity update) for a batch of bodies.  On CUDA
tensors it launches the hand-written kernel ``csrc/gs_frame.cu`` once; on
CPU tensors it runs ``gs_frame_reference``, the same frame in plain torch
built from ``solvers/neohookean.py``.  ``launch_count`` counts the kernel's
launches.

The kernel keeps a body's particle state in one block's shared memory, so
a mesh fits when its 9 f32 planes do (``check_fits``).  It reads the
slot-major tables of ``TetArrays`` as they are, for any number of levels:
the greedy schedule (fewest levels) for ``FusedGSBody`` and the ordered
one for ``Body``.  ``walk`` picks how the kernel walks the levels from the
schedule's width.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..mesh import TetArrays, TetMesh, build_arrays
from ..params import PhysicsParams
from ..solvers import neohookean
from ..spans import kernel, span
from . import build
from .batch import (SMEM_LIMIT, BodyField, FusedBatch, cached_params, expect,
                    prepared)

THREADS = 256  # threads per block, as kThreads in csrc/gs_frame.cu
WARP = 32  # the widest level the warp walk takes: a lane per slot
WALKS = {"block": 0, "warp": 1}  # kBlockWalk, kWarpWalk in csrc/gs_frame.cu

launch_count = 0  # launches of the CUDA kernel since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


def smem_bytes(num_particles: int) -> int:
    """Shared memory of one block: 9 particle planes + one float per warp."""
    return 4 * (9 * num_particles + THREADS // 32)


def walk(num_slots: int) -> str:
    """How ``csrc/gs_frame.cu`` walks a schedule whose widest level has
    ``num_slots`` slots: "warp" (warp 0, a lane per slot, a warp barrier
    between levels) where one warp holds a level, else "block" (every
    thread, a block barrier between levels)."""
    return "warp" if num_slots <= WARP else "block"


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the fused frame kernel keeps a body in shared memory: "
            f"{num_particles} particles need {need} bytes, a Hopper block "
            f"has {SMEM_LIMIT} (at most {(SMEM_LIMIT // 4 - THREADS // 32) // 9} "
            "particles); use the neohookean engine on a smaller mesh"
        )


def frame_flops(arr: TetArrays, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame, counted from
    ``csrc/gs_frame.cu`` (adds, multiplies, divides, square roots; compares,
    clamps, selects and the data-dependent ground friction are not
    counted): 421 per valid tet and substep (both constraint projections
    and the vol_err sum), 13 per particle and substep (predict, velocity)."""
    m, n = int(arr.slot_valid.sum()), arr.num_particles
    return num_bodies * params.num_substeps * (421 * m + 13 * n)


def frame_bytes(arr: TetArrays, params: PhysicsParams, num_bodies: int,
                num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (pos, vel, a tet's
    slot-table constants at 73 bytes, once per tet: padded slots carry no
    work, inv_mass, grabs), each output written once (pos, prev, vel,
    vol_err)."""
    n = arr.num_particles
    tets = int(arr.slot_valid.sum())
    return (num_bodies * (5 * 12 * n + 4 * params.num_substeps
                          + 16 * num_grabs) + 73 * tets + 4 * n)


class _FrameParams(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float), ("gdt", ctypes.c_float),
        ("k_fric", ctypes.c_float), ("dev_scale", ctypes.c_float),
        ("vol_scale", ctypes.c_float), ("gamma", ctypes.c_float),
        ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
    ]


def _frame_params(params: PhysicsParams) -> _FrameParams:
    """The frame's scalars in f32, with the plain path's operation order,
    built once per set of parameter values."""
    return cached_params(params, _build_frame_params)


def _build_frame_params(params: PhysicsParams) -> _FrameParams:
    dt = params.dt
    dt2 = dt * dt
    return _FrameParams(
        dt, params.gravity * dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        params.dev_compliance / dt2, params.vol_compliance / dt2,
        params.gamma,
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
    )


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments declared."""
    lib = build.load("gs_frame")
    if lib.gs_frame_launch.argtypes is None:
        lib.gs_frame_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
            + [_FrameParams, ctypes.c_void_p]
        )
        lib.gs_frame_launch.restype = ctypes.c_int
        lib.gs_frame_prepare.argtypes = [ctypes.c_int]
        lib.gs_frame_prepare.restype = ctypes.c_int
        lib.gs_frame_error_string.argtypes = [ctypes.c_int]
        lib.gs_frame_error_string.restype = ctypes.c_char_p
        lib.gs_frame_threads.restype = ctypes.c_int
        if lib.gs_frame_threads() != THREADS:
            raise RuntimeError("csrc/gs_frame.cu kThreads != gs_fused.THREADS")
    return lib


def _gs_frame_cuda(pos, vel, arr: TetArrays, params: PhysicsParams,
                   grab_id, grab_pos, level_walk: Optional[str] = None):
    """The launch; ``level_walk`` overrides ``walk(C)`` so that a check can
    hold the two walks to each other on one schedule."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the fused frame kernel runs on CUDA, not {dev}")
    if arr.slot_tets is None:
        raise ValueError("the fused frame kernel needs a GS schedule "
                         "(build_arrays(..., coloring='ordered'|'greedy'))")
    B, N = pos.shape[0], arr.num_particles
    L, C = arr.slot_valid.shape
    G = grab_id.shape[-1]
    S = params.num_substeps
    check_fits(N)
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

    code = WALKS[level_walk or walk(C)]

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    vol_err = torch.empty((B, S), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = prepared(lib, "gs_frame", dev, N)
        if err == 0:
            err = lib.gs_frame_launch(
                pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
                prev_out.data_ptr(), vel_out.data_ptr(), vol_err.data_ptr(),
                arr.slot_tets.data_ptr(), arr.slot_inv_rest_pose.data_ptr(),
                arr.slot_inv_rest_volume.data_ptr(), arr.slot_inv_mass.data_ptr(),
                arr.slot_valid.data_ptr(), arr.inv_mass.data_ptr(),
                grab_id.data_ptr(), grab_pos.data_ptr(),
                B, N, L, C, G, S, arr.num_tets, code, _frame_params(params),
                torch.cuda.current_stream(dev).cuda_stream,
            )
    if err != 0:
        raise RuntimeError(
            f"gs_frame launch failed: {lib.gs_frame_error_string(err).decode()}"
        )
    launch_count += 1
    return pos_out, prev_out, vel_out, vol_err


def gs_frame_reference(pos, vel, arr: TetArrays, params: PhysicsParams,
                       grab_id, grab_pos):
    """The frame in plain torch on any device: pos/vel [B,N,3], grabs
    grab_id int32 [B,G] and grab_pos [B,G,3].
    Returns (pos, prev_pos, vel, vol_err [B, num_substeps])."""
    dt = params.dt
    prev_pos = pos
    errs = []
    for _ in range(params.num_substeps):
        pos, prev_pos, vel, err = neohookean.substep_positions(
            pos, vel, arr, params, dt, grab_id, grab_pos
        )
        errs.append(err)
    vol_err = (torch.stack(errs, dim=-1) if errs
               else pos.new_zeros((pos.shape[0], 0)))
    return pos, prev_pos, vel, vol_err


def gs_frame(pos, vel, arr: TetArrays, params: PhysicsParams, grab_id,
             grab_pos):
    """One frame for B bodies (see ``gs_frame_reference`` for shapes).
    CPU tensors take the plain path; any other device launches the CUDA
    kernel or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return gs_frame_reference(pos, vel, arr, params, grab_id, grab_pos)
        return _gs_frame_cuda(pos, vel, arr, params, grab_id, grab_pos)


class FusedGSBody(FusedBatch):
    """A batch of bodies of one mesh stepped by the fused frame kernel, one
    launch per frame for the whole batch (or for each part of a sharded
    batch), each body with its own grab (state and grab API:
    ``FusedBatch``)."""

    last_diag = BodyField()

    def __init__(
        self,
        mesh: TetMesh,
        num_bodies: int = 8,
        density: float = 1000.0,
        coloring: str = "greedy",
        jitter: float = 0.0,
        seed: int = 0,
        device="cuda",
    ):
        check_fits(mesh.num_particles)
        super().__init__(mesh, num_bodies, jitter, seed, device)
        self.arrays = build_arrays(mesh, density, coloring, device=self.device)
        self.last_diag = None

    def shard(self, mesh, axis="body"):
        """Split the batch over the devices of ``mesh``'s ``axis`` (a
        ``parallel.DeviceMesh``; a name or a tuple of names): one contiguous
        sub-batch per device, the tables replicated.  ``step`` then
        launches the kernel once per device and frame; bodies are
        independent, so nothing passes between devices."""
        return self._shard(mesh, axis)

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every body by ``frames`` frames; returns the last frame's
        vol_err [num_bodies, num_substeps] (a device tensor, no sync)."""
        for _ in range(frames):
            self._step_parts(gs_frame, params, ("pos", "vel"),
                             ("pos", "prev_pos", "vel", "last_diag"))
        return self.last_diag
