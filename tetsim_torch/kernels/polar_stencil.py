"""Polar stencil substeps on grid_mesh boxes (counterpart of
``tetsim_tpu/kernels/polar_stencil.py``): the ``polar_grid_pallas``
engine.

``grid_frame`` runs one frame (every substep: predict, the 6 Kuhn tets of
every cube with extract_rotation, the 8-slab inverse stencil, apply,
collide, grab, velocity) for B boxes of one size.  On CUDA tensors it
launches the hand-written kernels of ``csrc/polar_stencil.cu``, two per
substep; on CPU tensors it runs ``grid_frame_reference``, the same frame in
plain torch from ``solvers/polar_grid.py``.  ``launch_count`` counts the
kernel launches.

Between the kernel's two passes a cube's tet deltas live as 24 slab sums
(slab s, coordinate r at row 3s + r of a scratch [B, 24, C]), each summed
over the cube's 6 types in order in shared memory by a block of ``STRIP``
cubes; ``block_plan``, ``slab_sums_reference`` and ``gather24_reference``
write that layout out in plain Python and torch for the tests.

The state is kept in the kernel's layout: planes pos / prev / vel
[B, 3, N] and quaternions [B, 6, 4, C] (C = nx*ny*nz cubes, type-major
like ``SimState.quats``).  ``make_frame_stepper`` keeps a body in that
layout across frames; ``step_frame`` converts a SimState each frame and
reports NaN as its per-substep diagnostic, as K4 does.

``make_grid_sharded_stepper`` runs the box in x-slabs (K4a): pass A and
one vertex pass per substep on each device, the vertex pass completing
each shared plane from the neighbour slab's sums
(``folded_gather_reference`` writes that order out in plain torch);
``acc_launch_count`` counts its launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..params import PhysicsParams
from ..state import SimState, Controls
from ..solvers import common, polar_grid
from ..solvers.polar_grid import GridArrays
from ..parallel.slabs import device_groups, ungroup
from ..spans import kernel, span
from . import build
from .batch import cached_params, expect

LAUNCHES_PER_SUBSTEP = 2  # as polar_stencil_launches_per_substep()
STRIP = 32  # cubes per block of pass A, as polar_stencil_strip()
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry
SLAB_LAUNCHES_PER_SUBSTEP = 2  # K4a per device, as
#                                 polar_stencil_slab_launches_per_substep()
acc_launch_count = 0  # launches of the slab form (K4a) since import (or reset)


def frame_flops(arr: GridArrays, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame, counted as for
    ``polar_fused.frame_flops`` (the per-tet arithmetic is the same): per
    tet and substep 391 plus 136 per extract_rotation iteration, per
    particle 19 plus 3 per incident corner (4 per tet in all).  The
    kernel's second predict of a corner per tet is not counted."""
    m, n = arr.num_tets, arr.num_particles
    per_substep = m * (391 + 136 * params.extract_iters) + 19 * n + 12 * m
    return num_bodies * params.num_substeps * per_substep


def frame_bytes(arr: GridArrays, num_bodies: int, num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (pos, vel,
    quaternions, inv_mass, den, grabs), each output written once (pos,
    prev, vel, quaternions); the kernel's slab-sum scratch is not
    counted."""
    n, m = arr.num_particles, arr.num_tets
    state = num_bodies * (2 * 12 * n + 16 * m + 16 * num_grabs)
    out = num_bodies * (3 * 12 * n + 16 * m)
    return state + out + 8 * n


class _GridPolarParams(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float), ("gdt", ctypes.c_float),
        ("k_fric", ctypes.c_float),
        ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
        ("rest_volume", ctypes.c_float),
        ("rest_centered", ctypes.c_float * 72),
        ("corner_slab", ctypes.c_int * 24),
        ("slab_items", ctypes.c_int * 48),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("iters", ctypes.c_int),
    ]


def _grid_params(arr: GridArrays, params: PhysicsParams) -> _GridPolarParams:
    """The frame's scalars in f32, with the plain path's operation order,
    and the box's per-type constants."""
    dt = params.dt
    rc = np.asarray(arr.rest_centered, np.float32).reshape(-1)
    cs = np.asarray(arr.corner_slab, np.int32).reshape(-1)
    return _GridPolarParams(
        dt, params.gravity * dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
        arr.rest_volume, (ctypes.c_float * 72)(*rc.tolist()),
        (ctypes.c_int * 24)(*cs.tolist()),
        (ctypes.c_int * 48)(*slab_items(arr.corner_slab).reshape(-1).tolist()),
        *arr.dims, params.extract_iters,
    )


def slab_items(corner_slab) -> np.ndarray:
    """int32 [8, 6]: for each slab s the corners 4t + c that lie in it, by
    type in order (a tet has at most one corner in a slab), then -1: the
    terms of pass A's slab sum."""
    out = np.full((8, 6), -1, np.int32)
    for s in range(8):
        items = [4 * t + c for t in range(6) for c in range(4)
                 if corner_slab[t][c] == s]
        out[s, :len(items)] = items
    return out


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its arguments
    declared."""
    lib = build.load("polar_stencil", NVCC_FLAGS)
    if lib.polar_stencil_launch.argtypes is None:
        lib.polar_stencil_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
            + [_GridPolarParams, ctypes.c_void_p]
        )
        lib.polar_stencil_launch.restype = ctypes.c_int
        lib.polar_stencil_error_string.argtypes = [ctypes.c_int]
        lib.polar_stencil_error_string.restype = ctypes.c_char_p
        lib.polar_stencil_launches_per_substep.restype = ctypes.c_int
        lib.polar_stencil_strip.restype = ctypes.c_int
        if lib.polar_stencil_launches_per_substep() != LAUNCHES_PER_SUBSTEP:
            raise RuntimeError("csrc/polar_stencil.cu launches per substep != "
                               "polar_stencil.LAUNCHES_PER_SUBSTEP")
        lib.polar_stencil_slab_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
            + [_GridPolarParams, ctypes.c_void_p])
        lib.polar_stencil_slab_launch.restype = ctypes.c_int
        lib.polar_stencil_slab_launches_per_substep.restype = ctypes.c_int
        if (lib.polar_stencil_slab_launches_per_substep()
                != SLAB_LAUNCHES_PER_SUBSTEP):
            raise RuntimeError("csrc/polar_stencil.cu slab launches per "
                               "substep != SLAB_LAUNCHES_PER_SUBSTEP")
    return lib


def _grid_frame_cuda(pos, vel, quats, arr: GridArrays, params: PhysicsParams,
                     grab_id, grab_pos):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the polar stencil kernel runs on CUDA, not {dev}")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N = pos.shape[0], arr.num_particles
    C = arr.num_tets // 6
    G = grab_id.shape[-1]
    f32 = torch.float32
    expect(pos, "pos", f32, (B, 3, N), dev)
    expect(vel, "vel", f32, (B, 3, N), dev)
    expect(quats, "quats", f32, (B, 6, 4, C), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    nx, ny, nz = arr.dims
    expect(arr.inv_mass, "inv_mass", f32, (nx + 1, ny + 1, nz + 1), dev)
    expect(arr.den, "den", f32, (nx + 1, ny + 1, nz + 1), dev)

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    quat_out = torch.empty_like(quats)
    sums = scratch(B, C, dev)
    with torch.cuda.device(dev):  # the launches go to the current device
        err = lib.polar_stencil_launch(
            pos.data_ptr(), vel.data_ptr(), quats.data_ptr(),
            pos_out.data_ptr(), prev_out.data_ptr(), vel_out.data_ptr(),
            quat_out.data_ptr(), sums.data_ptr(), arr.inv_mass.data_ptr(),
            arr.den.data_ptr(), grab_id.data_ptr(), grab_pos.data_ptr(),
            B, G, S, _grid_params(arr, params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("polar_stencil launch failed: "
                           f"{lib.polar_stencil_error_string(err).decode()}")
    launch_count += LAUNCHES_PER_SUBSTEP * S
    return pos_out, prev_out, vel_out, quat_out


grid_frame_reference = polar_grid.frame_reference


def grid_frame(pos, vel, quats, arr: GridArrays, params: PhysicsParams,
               grab_id, grab_pos):
    """One frame for B boxes: pos/vel [B, 3, N], quats [B, 6, 4, C],
    grab_id int32 [B, G], grab_pos [B, G, 3]; returns (pos, prev_pos, vel,
    quats).  CPU tensors take the plain path; any other device launches the
    CUDA kernels or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return grid_frame_reference(pos, vel, quats, arr, params, grab_id,
                                        grab_pos)
        return _grid_frame_cuda(pos, vel, quats, arr, params, grab_id, grab_pos)


def make_frame_stepper(arr: GridArrays):
    """(pack, step, unpack, unpack_pos) over state in the kernel's layout.

    pack(state, params)            -> packed (pos, prev, vel, quats), B = 1
    step(packed, params, controls) -> packed   (num_substeps substeps)
    unpack(packed, params)         -> SimState
    unpack_pos(packed)             -> positions [N, 3]

    The packed state carries the velocity (as the XLA engine does), so a
    change of dt between steps needs no conversion."""

    def pack(state: SimState, params: PhysicsParams):
        del params
        return (polar_grid.planes(state.pos)[None],
                polar_grid.planes(state.prev_pos)[None],
                polar_grid.planes(state.vel)[None],
                polar_grid.quats_to_kernel(state.quats, arr)[None])

    def step(packed, params: PhysicsParams, controls: Controls):
        gid, gpos = common.norm_grabs(controls)
        pos, prev, vel, quats = grid_frame(packed[0], packed[2], packed[3],
                                           arr, params, gid[None], gpos[None])
        return pos, prev, vel, quats

    def unpack(packed, params: PhysicsParams) -> SimState:
        del params
        pos, prev, vel, quats = packed
        return SimState(pos=polar_grid.unplanes(pos[0]),
                        prev_pos=polar_grid.unplanes(prev[0]),
                        vel=polar_grid.unplanes(vel[0]),
                        quats=polar_grid.quats_from_kernel(quats[0]))

    def unpack_pos(packed):
        return polar_grid.unplanes(packed[0][0])

    return pack, step, unpack, unpack_pos


def step_frame(state: SimState, arr: GridArrays, params: PhysicsParams,
               controls: Controls):
    """One frame through ``grid_frame`` (engine API).  The kernel computes
    no volume error, so the per-substep diagnostic is NaN."""
    pack, step, unpack, _ = make_frame_stepper(arr)
    new = unpack(step(pack(state, params), params, controls), params)
    return new, state.pos.new_full((params.num_substeps,), float("nan"))


def substep(state: SimState, arr: GridArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One substep (engine API): a frame of params with num_substeps=1."""
    del dt
    one = dataclasses.replace(params, num_substeps=1)
    new, diags = step_frame(state, arr, one, controls)
    return new, diags[0]


# -- the kernel's layout in plain Python and torch -----------------------------


def scratch(b: int, c: int, device) -> torch.Tensor:
    """The slab sums between the two passes: f32 [B, 24, C]."""
    return torch.empty((b, 24, c), dtype=torch.float32, device=device)


def block_plan(dims, strip: int = STRIP):
    """Pass A's threads on a box of ``dims`` cubes: (cube, type) int64
    [blocks, 6 * strip], thread (t, w) = (i // strip, i % strip) of block x
    on cube x * strip + w, type t; -1 on the last strip's idle threads."""
    c = dims[0] * dims[1] * dims[2]
    blocks = -(-c // strip)
    t, w = np.divmod(np.arange(6 * strip), strip)
    cube = np.arange(blocks)[:, None] * strip + w[None, :]
    live = cube < c
    return (np.where(live, cube, -1),
            np.where(live, np.broadcast_to(t, cube.shape), -1))


def slab_sums_reference(deltas, corner_slab):
    """The slab sums of pass A from the tets' weighted goal deltas
    ``deltas`` [B, 6, 4, 3, C] (type, corner, coordinate, cube): row 3s + r
    of the result [B, 24, C] adds, from 0 and over the types in order, the
    delta of type t's corner in slab s (a tet has at most one)."""
    b, _, _, _, c = deltas.shape
    out = deltas.new_zeros((b, 24, c))
    for s in range(8):
        for r in range(3):
            acc = deltas.new_zeros((b, c))
            for t in range(6):
                for k in range(4):
                    if corner_slab[t][k] == s:
                        acc = acc + deltas[:, t, k, r]
            out[:, 3 * s + r] = acc
    return out


def gather_reference(sums, dims, vi, vj, vk):
    """Pass B's numerators [B, 3, V] at the vertices (vi, vj, vk) (int64
    tensors [V]) from the slab sums [B, 24, C], by the kernel's index
    arithmetic (``gather``): each adds, in slab order s = 0..7 from 0, the
    sums of slab s of cube (vi - dx, vj - dy, vk - dz), s = 4 dx + 2 dy +
    dz, where that cube exists."""
    nx, ny, nz = dims
    num = sums.new_zeros((sums.shape[0], 3, vi.numel()))
    for s, (dx, dy, dz) in enumerate(polar_grid.SLAB_OFFSETS):
        ci, cj, ck = vi - dx, vj - dy, vk - dz
        ok = ((ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny) & (ck >= 0)
              & (ck < nz))
        cube = ((ci * ny + cj) * nz + ck).clamp(min=0, max=nx * ny * nz - 1)
        for r in range(3):
            num[:, r] = torch.where(ok, num[:, r] + sums[:, 3 * s + r, cube],
                                    num[:, r])
    return num


def _vertices(dims, device):
    nx, ny, nz = dims
    gy, gz = ny + 1, nz + 1
    v = torch.arange((nx + 1) * gy * gz, device=device)
    return v // (gy * gz), (v // gz) % gy, v % gz


def gather24_reference(sums, dims):
    """Pass B's numerators [B, 3, N] from the slab sums [B, 24, C] at every
    vertex v = (i*gy + j)*gz + k of the box (``gather_reference``)."""
    return gather_reference(sums, dims, *_vertices(dims, sums.device))


def folded_gather_reference(sums, dims):
    """K4a's pass B numerators [k, 3, N] of k consecutive slabs from their
    sums [k, 24, C] (``dims`` a slab's local dims), by the kernel's order:
    each vertex gathers its own slab's sums; a vertex (0, j, k) of slab b >
    0 then adds the gather of slab b - 1's sums at its mirror vertex (lx, j,
    k), and a vertex (lx, j, k) of slab b + 1 < k the gather of slab b + 1's
    sums at (0, j, k)."""
    vi, vj, vk = _vertices(dims, sums.device)
    lx = dims[0]
    num = gather_reference(sums, dims, vi, vj, vk)
    for plane, mirror, peer in ((0, lx, slice(None, -1)),
                                (lx, 0, slice(1, None))):
        at = vi == plane
        m = gather_reference(sums[peer], dims, torch.full_like(vi[at], mirror),
                             vj[at], vk[at])
        own = slice(1, None) if plane == 0 else slice(None, -1)
        num[own, :, at] = num[own, :, at] + m
    return num


# -- the slab form (K4a) ---------------------------------------------------------


def slab_calls(num_substeps: int, one_device: bool) -> list:
    """K4a's host calls of one frame on each device, as (begin, end,
    exchange): each launches phases [begin, end) of the frame's 2 S phases,
    a kernel each (pass A of substep s is phase 2s, its vertex pass 2s +
    1).  Where the mesh's slabs lie on one device, one call runs the whole
    frame.  Else a call ends after each pass A with exchange "halo": the
    host copies the boundary cube column of the sums across each device cut
    before the vertex pass that gathers it; None after the frame's last
    call."""
    total = 2 * num_substeps
    if one_device:
        return [(0, total, None)]
    bounds = [0] + list(range(1, total, 2)) + [total]
    return [(begin, end, None if end == total else "halo")
            for begin, end in zip(bounds, bounds[1:])]


def make_grid_sharded_stepper(mesh, garr: GridArrays, axis: str = "x"):
    """(prepare, step, unprepare) for the stencil kernel over ``mesh``'s
    x-slabs (``parallel.SlabMesh``; ``axis`` names its one axis).

    prepare(state, params)         -> packed ``GridSlabState``
    step(packed, params, controls) -> packed  (num_substeps substeps)
    unprepare(packed, params)      -> SimState

    On CUDA slabs a substep is two launches of K4a per device
    (``csrc/polar_stencil.cu``), pass A and a vertex pass that completes
    each shared plane from the neighbour slab's sums, a frame's launches
    enqueued by one host call; over several devices, the sums' boundary
    columns are copied across the device cuts between the two
    (``slab_calls``).  On CPU slabs it is
    ``polar_grid.make_grid_sharded_step``, the plain ``_substep`` with the
    halo hook (``SlabMesh.add_halo``), whose bits K4a keeps."""
    del axis
    d = mesh.size
    lx = polar_grid.slab_width(garr.dims, d)
    local = dataclasses.replace(garr, dims=(lx,) + tuple(garr.dims[1:]))
    slab_arr = polar_grid.grid_slab_arrays(garr, mesh)
    twin = polar_grid.make_grid_sharded_step(mesh, garr)

    def prepare(state: SimState, params: PhysicsParams):
        del params
        return polar_grid.grid_prepare(state, garr, mesh)[0]

    struct = functools.partial(_grid_params, local)  # made once per params

    def step(packed, params: PhysicsParams, controls: Controls):
        with span(_SPAN):
            if all(p.device.type == "cpu" for p in packed.pos):
                return twin(packed, slab_arr, params, controls)[0]
            return _slab_frame_cuda(packed, slab_arr, mesh, local,
                                    cached_params(params, struct), params,
                                    controls)

    def unprepare(packed, params: PhysicsParams) -> SimState:
        del params
        return polar_grid.grid_unprepare(packed, garr, d)

    return prepare, step, unprepare


def _slab_frame_cuda(packed, slab_arr, mesh, local: GridArrays,
                     par: _GridPolarParams, params: PhysicsParams,
                     controls: Controls):
    global acc_launch_count
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    lib = library()
    lx, ny, nz = local.dims
    n, c = local.num_particles, local.num_tets // 6
    gyz = (ny + 1) * (nz + 1)
    gid, gpos = common.norm_grabs(controls)
    f32 = torch.float32
    groups = device_groups(mesh, pos=packed.pos, vel=packed.vel,
                           quats=packed.quats, im=slab_arr.inv_mass,
                           den=slab_arr.den)
    many = len(groups) > 1
    for g in groups:
        k, dev = g["k"], g["dev"]
        if 24 * k * c >= 2**31:
            raise ValueError(f"{k} slabs of {c} cubes overflow K4a's indices")
        for name, shape in (("pos", (k, 3, n)), ("vel", (k, 3, n)),
                            ("quats", (k, 24, c)), ("im", (k, n)),
                            ("den", (k, n))):
            expect(g[name], name, f32, shape, dev)
        g.update(gid=gid.to(dev, torch.int32).contiguous(),
                 gpos=gpos.to(dev, f32).contiguous(),
                 pos_out=torch.empty_like(g["pos"]),
                 prev_out=torch.empty_like(g["pos"]),
                 vel_out=torch.empty_like(g["pos"]),
                 quat_out=torch.empty_like(g["quats"]),
                 sums=scratch(k, c, dev),
                 left=scratch(1, c, dev)[0] if many and g["first"] else None,
                 right=(scratch(1, c, dev)[0]
                        if many and g["first"] + k < mesh.size else None))
    calls = slab_calls(S, not many)
    if many:  # the sums' boundary columns across the device cuts
        cuts = mesh.device_cuts()
        col = [slice((lx - 1) * ny * nz, lx * ny * nz), slice(0, ny * nz)]
        sums = [x for g in groups for x in ungroup(g["sums"])]
        ghost_lo, ghost_hi = [None] * mesh.size, [None] * mesh.size
        for g in groups:
            if g["left"] is not None:
                ghost_lo[g["first"]] = g["left"][:, col[0]]
            if g["right"] is not None:
                ghost_hi[g["first"] + g["k"] - 1] = g["right"][:, col[1]]
        hi_col = [x[:, col[0]] for x in sums]
        lo_col = [x[:, col[1]] for x in sums]
    for begin, end, exchange in calls:
        for g in groups:
            with torch.cuda.device(g["dev"]):
                err = lib.polar_stencil_slab_launch(
                    g["pos"].data_ptr(), g["vel"].data_ptr(),
                    g["quats"].data_ptr(), g["pos_out"].data_ptr(),
                    g["prev_out"].data_ptr(), g["vel_out"].data_ptr(),
                    g["quat_out"].data_ptr(), g["sums"].data_ptr(),
                    None if g["left"] is None else g["left"].data_ptr(),
                    None if g["right"] is None else g["right"].data_ptr(),
                    g["im"].data_ptr(), g["den"].data_ptr(),
                    g["gid"].data_ptr(), g["gpos"].data_ptr(), g["k"],
                    g["gid"].shape[0], g["first"] * lx * gyz, lx * gyz,
                    begin, end, par, g["stream"])
            if err != 0:
                raise RuntimeError(
                    "polar_stencil slab launch failed: "
                    f"{lib.polar_stencil_error_string(err).decode()}")
        if exchange == "halo":
            mesh.send_right(hi_col, ghost_lo, pairs=cuts)  # i - 1 -> i
            mesh.send_left(lo_col, ghost_hi, pairs=cuts)  # i -> i - 1
    acc_launch_count += sum(end - begin for begin, end, _ in calls) * len(
        groups)
    return polar_grid.GridSlabState(
        **{f: [x for g in groups for x in ungroup(g[k])]
           for f, k in (("pos", "pos_out"), ("prev", "prev_out"),
                        ("vel", "vel_out"), ("quats", "quat_out"))})
