"""Fused polar shape-matching frame for B bodies of one mesh (counterpart
of ``tetsim_tpu/kernels/polar_fused.py``).

``polar_frame`` runs one whole frame (every substep: predict, the per-tet
polar solve, the per-particle Jacobi average, collide, grab, velocity
update) for a batch of bodies.  On CUDA tensors it launches the
hand-written kernel ``csrc/polar_frame.cu`` once; on CPU tensors it runs
``polar_frame_reference``, the same frame in plain torch built from
``solvers/polar.py``.  ``launch_count`` counts the kernel's launches.

The kernel reads ``TetArrays``' own tables in the original tet order
(``tets``, ``rest_centered``, ``rest_volume``, ``inv_mass``, ``inc_idx``,
``inc_den``) and runs a body on a cluster of blocks, each of which keeps
a replica of the body's particle state in its shared memory, so a mesh
fits when its 9 f32 planes do (``check_fits``).  ``cluster_size`` picks
the blocks per body from the batch and from the cluster sizes the card
schedules; ``split`` gives each block's tets and particles.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..mesh import TetArrays, TetMesh, build_arrays
from ..params import PhysicsParams
from ..solvers import polar
from ..spans import kernel, span
from . import build
from .batch import (SMEM_LIMIT, BodyField, FusedBatch, cached_params, expect,
                    prepared)

THREADS = 512  # threads per block, as kThreads in csrc/polar_frame.cu
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16: Hopper's largest (non-portable)
MAX_CLUSTER = CLUSTER_SIZES[-1]
SMS = 132  # SMs of an H100 SXM
# the kernel's own nvcc flags: none, so nvcc contracts multiply-adds into
# FMAs (profile_frame.py times it against a -fmad=false build; see the note
# in csrc/polar_frame.cu)
NVCC_FLAGS = ()

launch_count = 0  # launches of the CUDA kernel since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


def smem_bytes(num_particles: int) -> int:
    """Shared memory of one block: the 9 particle planes."""
    return 4 * 9 * num_particles


def cluster_size(num_bodies: int, max_cs: int, waves: Optional[dict] = None
                 ) -> int:
    """Blocks per body: the largest power of two no larger than ``max_cs``
    at which the batch's ``num_bodies`` clusters run in one wave; at least
    1.  ``waves[cs]`` is how many clusters of cs blocks the card runs at
    once (``active_clusters``); by default ``SMS // cs``, one block per
    SM."""
    def wave(cs):
        return SMS // cs if waves is None else waves[cs]

    cs = 1
    while cs * 2 <= max_cs and num_bodies <= wave(cs * 2):
        cs *= 2
    return cs


def split(n: int, cs: int) -> list:
    """The ranges [lo, hi) of n items over the cs blocks of a cluster, as
    ``csrc/polar_frame.cu`` cuts tets (phase A) and particles (phase B):
    ceil(n / cs) each, the last ones short or empty."""
    span = -(-n // cs)
    return [(min(n, r * span), min(n, r * span + span)) for r in range(cs)]


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the fused polar frame kernel keeps a body in shared memory: "
            f"{num_particles} particles need {need} bytes, a Hopper block "
            f"has {SMEM_LIMIT} (at most {SMEM_LIMIT // 36} particles); use "
            "a smaller mesh"
        )


def frame_flops(arr: TetArrays, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame, counted from
    ``csrc/polar_frame.cu`` (adds, multiplies, divides, square roots, sines
    and cosines; compares, clamps and selects are not counted): per tet and
    substep 391 plus 136 per extract_rotation iteration, per particle 19
    plus 3 per incident corner (4 per tet in all)."""
    m, n = arr.num_tets, arr.num_particles
    per_substep = m * (391 + 136 * params.extract_iters) + 19 * n + 12 * m
    return num_bodies * params.num_substeps * per_substep


def frame_bytes(arr: TetArrays, num_bodies: int, num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (state, quaternions,
    tables, grabs), each output written once (pos, prev, vel, quaternions);
    of inc_idx only its 4M live entries (the -1 padding carries no work),
    and the kernel's delta scratch is not counted."""
    n, m = arr.num_particles, arr.num_tets
    state = num_bodies * (2 * 12 * n + 16 * m)  # pos, vel, quats in
    out = num_bodies * (3 * 12 * n + 16 * m)  # pos, prev, vel, quats out
    tables = 16 * m + 48 * m + 4 * m + 4 * n + 4 * 4 * m + 4 * n
    grabs = num_bodies * num_grabs * 16
    return state + out + tables + grabs


class _PolarParams(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float), ("gdt", ctypes.c_float),
        ("k_fric", ctypes.c_float),
        ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
    ]


def _polar_params(params: PhysicsParams) -> _PolarParams:
    """The frame's scalars in f32, with the plain path's operation order,
    built once per set of parameter values."""
    return cached_params(params, _build_polar_params)


def _build_polar_params(params: PhysicsParams) -> _PolarParams:
    dt = params.dt
    return _PolarParams(
        dt, params.gravity * dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
    )


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments declared."""
    lib = build.load("polar_frame", NVCC_FLAGS)
    if lib.polar_frame_launch.argtypes is None:
        lib.polar_frame_launch.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
            + [_PolarParams, ctypes.c_void_p]
        )
        lib.polar_frame_launch.restype = ctypes.c_int
        lib.polar_frame_prepare.argtypes = [ctypes.c_int]
        lib.polar_frame_prepare.restype = ctypes.c_int
        lib.polar_frame_active_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.polar_frame_active_clusters.restype = ctypes.c_int
        lib.polar_frame_error_string.argtypes = [ctypes.c_int]
        lib.polar_frame_error_string.restype = ctypes.c_char_p
        lib.polar_frame_threads.restype = ctypes.c_int
        if lib.polar_frame_threads() != THREADS:
            raise RuntimeError("csrc/polar_frame.cu kThreads != polar_fused.THREADS")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"polar_frame {what} failed: "
            f"{lib.polar_frame_error_string(err).decode()}")


def active_clusters(device, num_particles: int) -> dict:
    """{cs: clusters of cs blocks the card runs at once with one block on
    each SM} for each cluster size, each block with the shared memory of
    ``num_particles`` (cudaOccupancyMaxActiveClusters on ``device``; 0
    where it runs none).  Raises on a CUDA error."""
    lib = library()
    out = {}
    with torch.cuda.device(device):
        _check(lib, prepared(lib, "polar_frame", device, num_particles),
               "prepare")
        for cs in CLUSTER_SIZES:
            count = ctypes.c_int(0)
            _check(lib, lib.polar_frame_active_clusters(
                num_particles, cs, ctypes.byref(count)),
                f"occupancy query at cs={cs}")
            out[cs] = count.value
    return out


def _waves(lib, device, num_particles: int) -> dict:
    """``active_clusters``, asked once per library, device and size."""
    waves = lib.__dict__.setdefault("waves", {})
    key = (device.index, num_particles)
    if key not in waves:
        waves[key] = active_clusters(device, num_particles)
    return waves[key]


def _polar_frame_cuda(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                      grab_id, grab_pos, cs: Optional[int] = None):
    """The launch; ``cs`` overrides ``cluster_size`` so that a check can run
    every cluster size the card schedules."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the fused polar frame kernel runs on CUDA, not {dev}")
    if arr.inc_idx is None:
        raise ValueError("the fused polar frame kernel needs the incidence "
                         "tables (build_arrays(..., coloring=None))")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N, M = pos.shape[0], arr.num_particles, arr.num_tets
    K = arr.inc_idx.shape[1]
    G = grab_id.shape[-1]
    check_fits(N)
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
    for t in (quats, arr.tets, arr.rest_centered):  # read as int4 / float4
        if t.data_ptr() % 16:
            raise ValueError("quats, tets and rest_centered must be 16-byte "
                             "aligned")

    lib = library()
    waves = _waves(lib, dev, N)
    if cs is None:
        cs = cluster_size(B, MAX_CLUSTER, waves)
    elif waves.get(cs, 0) < 1:
        raise ValueError(f"cluster size {cs}: the card runs clusters of "
                         f"{[c for c, n in waves.items() if n >= 1]} blocks")
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    quat_out = torch.empty_like(quats)
    delta = torch.empty((B, 4 * M, 4), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.polar_frame_launch(
            pos.data_ptr(), vel.data_ptr(), quats.data_ptr(),
            pos_out.data_ptr(), prev_out.data_ptr(), vel_out.data_ptr(),
            quat_out.data_ptr(), delta.data_ptr(), arr.tets.data_ptr(),
            arr.rest_centered.data_ptr(), arr.rest_volume.data_ptr(),
            arr.inv_mass.data_ptr(), arr.inc_idx.data_ptr(),
            arr.inc_den.data_ptr(), grab_id.data_ptr(), grab_pos.data_ptr(),
            B, cs, N, M, K, G, S, params.extract_iters, _polar_params(params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, err, f"launch (B={B}, cs={cs})")
    launch_count += 1
    return pos_out, prev_out, vel_out, quat_out


def polar_frame_reference(pos, vel, quats, arr: TetArrays,
                          params: PhysicsParams, grab_id, grab_pos):
    """The frame in plain torch on any device: pos/vel [B,N,3], quats
    [B,M,4], grabs grab_id int32 [B,G] and grab_pos [B,G,3].
    Returns (pos, prev_pos, vel, quats)."""
    prev_pos = pos
    for _ in range(params.num_substeps):
        pos, prev_pos, vel, quats = polar.substep_positions(
            pos, vel, quats, arr, params, params.dt, grab_id, grab_pos)
    return pos, prev_pos, vel, quats


def polar_frame(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                grab_id, grab_pos):
    """One frame for B bodies (see ``polar_frame_reference`` for shapes).
    CPU tensors take the plain path; any other device launches the CUDA
    kernel or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return polar_frame_reference(pos, vel, quats, arr, params, grab_id,
                                         grab_pos)
        return _polar_frame_cuda(pos, vel, quats, arr, params, grab_id,
                                 grab_pos)


class FusedPolarBody(FusedBatch):
    """A batch of bodies of one mesh stepped by the fused polar frame
    kernel, one launch per frame for the whole batch (or for each part of a
    sharded batch), each body with its own grab (state and grab API:
    ``FusedBatch``).  The quaternions are quats [B,M,4] (xyzw) in the
    mesh's tet order."""

    quats = BodyField()

    def __init__(
        self,
        mesh: TetMesh,
        num_bodies: int = 8,
        density: float = 1000.0,
        jitter: float = 0.0,
        seed: int = 0,
        pinned=None,
        device="cuda",
    ):
        check_fits(mesh.num_particles)
        super().__init__(mesh, num_bodies, jitter, seed, device)
        self.arrays = build_arrays(mesh, density, coloring=None, pinned=pinned,
                                   device=self.device)
        quats = torch.zeros((num_bodies, mesh.num_tets, 4),
                            dtype=torch.float32, device=self.device)
        quats[..., 3] = 1.0
        self.quats = quats

    def shard(self, mesh, axis="body"):
        """Split the batch over the devices of ``mesh``'s ``axis`` (a
        ``parallel.DeviceMesh``; a name or a tuple of names): one contiguous
        sub-batch per device, the tables replicated.  ``step`` then
        launches the kernel once per device and frame; bodies are
        independent, so nothing passes between devices."""
        return self._shard(mesh, axis)

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every body by ``frames`` frames (no sync)."""
        for _ in range(frames):
            self._step_parts(polar_frame, params, ("pos", "vel", "quats"),
                             ("pos", "prev_pos", "vel", "quats"))

    def quaternions(self) -> np.ndarray:
        """[num_bodies, M, 4] per-tet quaternions in the mesh's tet order."""
        return self.quats.cpu().numpy()
