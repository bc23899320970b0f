"""Polar shape-matching frames of one body too large for one block's shared
memory, one cooperative launch per frame (``csrc/polar_jacobi.cu``).

Replaces no TPU kernel: for such a body the JAX package runs its XLA
engine (``tetsim_tpu/solvers/polar.py``).  The port's fused frame kernel
(``polar_fused``, K2) keeps a body in one block's shared memory, at most
6,456 particles (``polar_fused.check_fits``); ``Body(engine="polar")`` on
the card runs this module above that.  The kernel walks a frame's substeps
inside one launch on a co-resident grid (``frame_grid``): a predict phase,
then per substep a tet pass and a particle pass with a grid barrier after
each (none after the last), the particle pass writing each particle's next
prediction.  Each pass deals its items to the grid a warp's chunk at a
time, round-robin over the blocks (one lane a tet, ``GROUP`` lanes a
particle); ``corner_tables`` says where the tet pass puts each corner's
delta so that a particle finds its deltas in its row's order.  What bounds
it on the card: the tet pass's dependent extract_rotation chain, with too
few threads per SM at ``grid_mesh(20, 20, 20)``'s 48,000 tets to hide
it.

``jacobi_frame`` runs one frame for B bodies of one mesh: on CUDA tensors
the kernel, on CPU tensors ``jacobi_frame_reference``, the plain-torch
frame of ``solvers/polar.py`` (the same twin as K2's).  ``launch_count``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..solvers import common
from ..state import Controls, SimState
from ..spans import kernel, span
from . import build
from .batch import expect
# frame_flops / frame_bytes: the same work as the fused frame kernel's
from .polar_fused import (_PolarParams, _polar_params, frame_bytes,  # noqa: F401
                          frame_flops, polar_frame_reference)

THREADS = 256  # threads per block (kThreads)
GROUP = 4  # lanes per particle in the particle pass (kGroup)
LAUNCHES_PER_FRAME = 1  # as polar_jacobi_launches_per_frame()
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry

_tables: dict = {}  # id(arr) -> (weakref to arr, table ids, device,
#                                  slots, inc_count)
_scratch: dict = {}  # (device, stream, B, N, K) -> (delta, pred4)


def corner_tables(inc_idx: torch.Tensor, num_tets: int):
    """(slots int32 [M, 4], inc_count int32 [N]) of the incidence table
    inc_idx [N, K]: corner k of tet t goes to place j N + p of the kernel's
    delta [K, N] rows, where inc_idx[p, j] = 4 t + k, and inc_count[p] is
    the live entries of row p.  So particle p reads its deltas at p, N + p,
    ..., in its row's order.  Made on inc_idx's device without a host
    sync."""
    n, k = inc_idx.shape
    live = inc_idx >= 0
    place = (torch.arange(k, device=inc_idx.device, dtype=torch.int32) * n)[
        None, :] + torch.arange(n, device=inc_idx.device,
                                dtype=torch.int32)[:, None]
    corners = 4 * num_tets
    slots = torch.full((corners + 1,), -1, dtype=torch.int32,
                       device=inc_idx.device)
    # padding entries all land on the spare last place, which is cut off
    slots.scatter_(0, torch.where(live, inc_idx, corners).reshape(-1).long(),
                   place.reshape(-1))
    return (slots[:corners].reshape(num_tets, 4).contiguous(),
            live.sum(1, dtype=torch.int32))


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments
    declared."""
    lib = build.load("polar_jacobi", NVCC_FLAGS)
    if lib.polar_jacobi_launch.argtypes is None:
        lib.polar_jacobi_launch.argtypes = (
            [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
            + [_PolarParams, ctypes.c_void_p]
        )
        lib.polar_jacobi_launch.restype = ctypes.c_int
        lib.polar_jacobi_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.polar_jacobi_occupancy.restype = ctypes.c_int
        lib.polar_jacobi_error_string.argtypes = [ctypes.c_int]
        lib.polar_jacobi_error_string.restype = ctypes.c_char_p
        lib.polar_jacobi_threads.restype = ctypes.c_int
        lib.polar_jacobi_group.restype = ctypes.c_int
        lib.polar_jacobi_launches_per_frame.restype = ctypes.c_int
        if (lib.polar_jacobi_threads() != THREADS
                or lib.polar_jacobi_group() != GROUP
                or lib.polar_jacobi_launches_per_frame() != LAUNCHES_PER_FRAME):
            raise RuntimeError("csrc/polar_jacobi.cu kThreads / kGroup / "
                               "launches per frame != polar_jacobi.THREADS / "
                               "GROUP / LAUNCHES_PER_FRAME")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"polar_jacobi {what} failed: "
                           f"{lib.polar_jacobi_error_string(err).decode()}")


def occupancy(device) -> tuple:
    """(blocks of the frame kernel one SM holds at once, SMs) on ``device``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once per
    device."""
    lib = library()
    known = lib.__dict__.setdefault("occupancy", {})
    if device.index not in known:
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            _check(lib, lib.polar_jacobi_occupancy(ctypes.byref(per_sm),
                                                   ctypes.byref(sms)),
                   "occupancy query")
        known[device.index] = (per_sm.value, sms.value)
    return known[device.index]


def frame_grid(device) -> int:
    """Blocks of the cooperative grid on ``device``: every block each SM
    holds at once.  Raises where an SM holds none."""
    per_sm, sms = occupancy(device)
    if per_sm < 1:
        raise RuntimeError(f"an SM of {device} holds no block of the "
                           "polar_jacobi frame kernel")
    return per_sm * sms


def _corner_tables(arr: TetArrays, dev, N: int, M: int, K: int):
    """The static tables' checks and ``corner_tables``, made once per
    TetArrays, device and set of table tensors."""
    tables = (arr.tets, arr.rest_centered, arr.rest_volume, arr.inv_mass,
              arr.inc_idx, arr.inc_den)
    ids = tuple(id(t) for t in tables)
    hit = _tables.get(id(arr))
    if hit is not None and hit[0]() is arr and hit[1:3] == (ids, dev):
        return hit[3:]
    f32 = torch.float32
    expect(arr.tets, "tets", torch.int32, (M, 4), dev)
    expect(arr.rest_centered, "rest_centered", f32, (M, 4, 3), dev)
    expect(arr.rest_volume, "rest_volume", f32, (M,), dev)
    expect(arr.inv_mass, "inv_mass", f32, (N,), dev)
    expect(arr.inc_idx, "inc_idx", torch.int32, (N, K), dev)
    expect(arr.inc_den, "inc_den", f32, (N,), dev)
    if arr.tets.data_ptr() % 16:  # read as int4
        raise ValueError("tets must be 16-byte aligned")
    if len(_tables) >= 64:
        _tables.clear()
    made = corner_tables(arr.inc_idx, M)
    _tables[id(arr)] = (weakref.ref(arr), ids, dev) + made
    return made


def _scratch_for(dev, stream, B: int, N: int, K: int):
    """The delta [B, K, N] and pred4 [B, N] scratch (float4) of frames on
    ``stream``, made once per (device, stream, B, N, K) and reused in
    stream order."""
    key = (dev, stream, B, N, K)
    hit = _scratch.get(key)
    if hit is None:
        if len(_scratch) >= 8:
            _scratch.clear()
        hit = _scratch[key] = (
            torch.empty((B, K, N, 4), dtype=torch.float32, device=dev),
            torch.empty((B, N, 4), dtype=torch.float32, device=dev))
    return hit


def _jacobi_frame_cuda(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                       grab_id, grab_pos):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the polar Jacobi kernel runs on CUDA, not {dev}")
    if arr.inc_idx is None:
        raise ValueError("the polar Jacobi kernel needs the incidence tables "
                         "(build_arrays(..., coloring=None))")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N, M = pos.shape[0], arr.num_particles, arr.num_tets
    K = arr.inc_idx.shape[1]
    if B * max(M, N) >= 2**31 or K * N >= 2**31:
        raise ValueError(f"{B} bodies of {M} tets overflow the kernel's "
                         "indices")
    G = grab_id.shape[-1]
    f32 = torch.float32
    expect(pos, "pos", f32, (B, N, 3), dev)
    expect(vel, "vel", f32, (B, N, 3), dev)
    expect(quats, "quats", f32, (B, M, 4), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    if quats.data_ptr() % 16:  # read as float4
        raise ValueError("quats must be 16-byte aligned")
    slots, inc_count = _corner_tables(arr, dev, N, M, K)

    lib = library()
    grid = frame_grid(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    delta, pred4 = _scratch_for(dev, stream, B, N, K)
    pos_out, prev_out, vel_out = torch.empty((3,) + pos.shape, dtype=f32,
                                             device=dev)
    quat_out = torch.empty_like(quats)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.polar_jacobi_launch(
            pos.data_ptr(), vel.data_ptr(), quats.data_ptr(),
            pos_out.data_ptr(), prev_out.data_ptr(), vel_out.data_ptr(),
            quat_out.data_ptr(), delta.data_ptr(), pred4.data_ptr(),
            arr.tets.data_ptr(), slots.data_ptr(),
            arr.rest_centered.data_ptr(), arr.rest_volume.data_ptr(),
            arr.inv_mass.data_ptr(), inc_count.data_ptr(),
            arr.inc_den.data_ptr(), grab_id.data_ptr(), grab_pos.data_ptr(),
            B, N, M, K, G, S, params.extract_iters, grid,
            _polar_params(params), stream,
        )
    _check(lib, err, f"cooperative launch of {grid} blocks")
    launch_count += LAUNCHES_PER_FRAME
    return pos_out, prev_out, vel_out, quat_out


jacobi_frame_reference = polar_frame_reference


def jacobi_frame(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                 grab_id, grab_pos):
    """One frame for B bodies: pos/vel [B,N,3], quats [B,M,4], grab_id
    int32 [B,G], grab_pos [B,G,3]; returns (pos, prev_pos, vel, quats).
    CPU tensors take the plain path; any other device launches the CUDA
    kernel or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return jacobi_frame_reference(pos, vel, quats, arr, params, grab_id,
                                          grab_pos)
        return _jacobi_frame_cuda(pos, vel, quats, arr, params, grab_id,
                                  grab_pos)


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
