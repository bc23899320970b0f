"""Neo-Hookean 48-colour stencil substeps on grid_mesh boxes (counterpart
of ``tetsim_tpu/kernels/nh_stencil.py``): the ``neohookean_grid_pallas``
engine.

``grid_frame`` runs one frame (every substep: predict, the 48 colours in
order, collide, grab, velocity) for B boxes of one size.  On CUDA tensors
it launches the hand-written kernel of ``csrc/nh_stencil.cu`` once per
frame, a cooperative launch whose grid (``frame_grid``, one block per SM)
walks the frame's phases (``phase_items`` says which block takes which
work, in items of ``item_lanes`` tet lanes), with a grid barrier on either
side of a particle phase and, between two colours, each item waiting only
for the items within ``reach`` of it; on CPU tensors it runs
``grid_frame_reference``, the same frame in plain torch from
``solvers/neohookean_grid.py``.  ``launch_count`` counts the kernel
launches.  ``vol_err=True`` also returns the per-substep volume
error of the XLA engine (mean det F - 1, summed in a fixed order); the
``neohookean_grid`` engine asks for it, this module's ``step_frame``
reports NaN as K3 does.

The state is kept in the kernel's layout, planes pos / prev / vel
[B, 3, N]; ``make_frame_stepper`` keeps a body in it across frames.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..params import PhysicsParams
from ..state import SimState, Controls
from ..solvers import common, neohookean_grid
from ..solvers.neohookean_grid import NHGridArrays
from ..solvers.polar_grid import planes, unplanes
from ..parallel.slabs import device_groups, plane, ungroup
from ..spans import kernel, span
from . import build
from .batch import cached_params, expect

COLORS = 48
THREADS = 256  # threads per block and tet lanes per virtual block (kThreads)
LAUNCHES_PER_FRAME = 1  # K3, as nh_stencil_launches_per_frame()
FLAG_INTS = 8  # K3's scratch ints per item flag (nh_stencil_flag_ints())
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry
# K3s per device, where the mesh's slabs lie on one device (as
# nh_stencil_slab_launches_per_frame(); slab_calls)
SLAB_LAUNCHES_PER_FRAME = 1
segment_launch_count = 0  # launches of the slab form (K3s) since import


def frame_flops(arr: NHGridArrays, params: PhysicsParams,
                num_bodies: int) -> int:
    """Floating-point operations of one frame, counted as for
    ``gs_fused.frame_flops`` (the tet projection is the same): 421 per tet
    and substep, 13 per particle and substep."""
    per_substep = 421 * arr.num_tets + 13 * arr.num_particles
    return num_bodies * params.num_substeps * per_substep


def frame_bytes(arr: NHGridArrays, params: PhysicsParams, num_bodies: int,
                num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (pos, vel, inv_mass,
    grabs), each output written once (pos, prev, vel, vol_err)."""
    n = arr.num_particles
    return (num_bodies * (5 * 12 * n + 4 * params.num_substeps
                          + 16 * num_grabs) + 4 * n)


class _GridNHParams(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float), ("gdt", ctypes.c_float),
        ("k_fric", ctypes.c_float), ("dev_scale", ctypes.c_float),
        ("vol_scale", ctypes.c_float), ("gamma", ctypes.c_float),
        ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
        ("irv", ctypes.c_float), ("ir", ctypes.c_float * 54),
        ("corner_slab", ctypes.c_int * 24),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
    ]


def _grid_params(arr: NHGridArrays, params: PhysicsParams) -> _GridNHParams:
    """The frame's scalars in f32, with the plain path's operation order,
    and the box's per-type constants."""
    dt = params.dt
    dt2 = dt * dt
    ir = np.asarray(arr.inv_rest_pose, np.float32).reshape(-1)
    cs = np.asarray(arr.corner_slab, np.int32).reshape(-1)
    return _GridNHParams(
        dt, params.gravity * dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        params.dev_compliance / dt2, params.vol_compliance / dt2,
        params.gamma,
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
        arr.inv_rest_volume, (ctypes.c_float * 54)(*ir.tolist()),
        (ctypes.c_int * 24)(*cs.tolist()), *arr.dims,
    )


_struct_makers: dict = {}  # box geometry -> maker of its frame struct


def _frame_params(arr: NHGridArrays, params: PhysicsParams) -> _GridNHParams:
    """``_grid_params``, built once per box geometry and set of parameter
    values (``batch.cached_params``): a launch's host work."""
    key = (arr.dims, arr.corner_slab, arr.inv_rest_pose, arr.inv_rest_volume)
    build = _struct_makers.get(key)
    if build is None:
        if len(_struct_makers) >= 64:
            _struct_makers.clear()
        build = _struct_makers[key] = functools.partial(_grid_params, arr)
    return cached_params(params, build)


def _largest_colour(dims) -> int:
    """Tets of the largest colour: its tet lanes."""
    nx, ny, nz = dims
    return ((nx + 1) // 2) * ((ny + 1) // 2) * ((nz + 1) // 2)


def partial_blocks(dims, lanes: int = THREADS) -> int:
    """Virtual blocks of ``lanes`` tet lanes that cover the largest colour:
    a colour phase's items per body (of THREADS lanes, ``partial_blocks``
    of ``csrc/nh_stencil.cu``, the volume error's block sums)."""
    return -(-_largest_colour(dims) // lanes)


def item_lanes(dims, num_bodies: int, grid: int, vol_err: bool) -> int:
    """Tet lanes of one of K3's colour-phase items: THREADS where the volume
    error is asked for (its sums are per virtual block of THREADS lanes, in
    a fixed order), else the largest colour's lanes spread over the grid's
    blocks, at least a warp's 32: 167 for the 56^3 box on 132 blocks, so
    that every SM takes a share of each colour."""
    if vol_err:
        return THREADS
    share = -(-_largest_colour(dims) // max(grid // num_bodies, 1))
    return min(THREADS, max(32, share))


@functools.lru_cache(maxsize=64)
def reach(dims, lanes: int = THREADS) -> int:
    """The widest distance in virtual blocks of ``lanes`` tet lanes between
    two tets, of any two colours, whose cubes share a vertex: how far K3's
    colour-phase item (b, vb) waits on its neighbours, items (b, vb - reach)
    .. (b, vb + reach), between two colours.  A cube (i, j, k) belongs to
    the colours of parity (i % 2, j % 2, k % 2), each of which puts it at
    tet lane (ax * cwy + ay) * cwz + az, (ax, ay, az) = ((i, j, k) -
    parity) // 2, cw* the parity's cubes along each axis (``color_corners``),
    so it lies in the same virtual block in all of them; the reach is the
    largest difference of that block between two cubes at most one apart
    along each axis.  For the 56^3 box 4 at 256 lanes, 5 at its 167
    (``item_lanes``); at most ``partial_blocks(dims, lanes) - 1``."""
    cube = np.indices(dims)  # [3, nx, ny, nz]
    cw = [(n - cube[a] % 2 + 1) // 2 for a, n in enumerate(dims)]
    ax, ay, az = cube // 2
    vb = ((ax * cw[1] + ay) * cw[2] + az) // lanes
    out = 0
    for d in np.ndindex(3, 3, 3):  # each pair of neighbours once, either way
        d = np.subtract(d, 1)
        if tuple(d) <= (0, 0, 0):
            continue
        a = vb[tuple(slice(max(-x, 0), n - max(x, 0))
                     for x, n in zip(d, dims))]
        b = vb[tuple(slice(max(x, 0), n - max(-x, 0))
                     for x, n in zip(d, dims))]
        if a.size:
            out = max(out, int(np.abs(a - b).max()))
    return out


def phase_items(num_bodies: int, dims, grid: int,
                lanes: int = THREADS) -> list:
    """K3's colour phase over a grid of ``grid`` blocks: for each block, the
    (body, virtual block) pairs it takes, grid-stride over items = body *
    nblk + virtual block, as ``nh_grid_frame_kernel`` walks them.  Thread j
    < ``lanes`` of a block solves tet lane vb * lanes + j of the colour
    (``color_corners``).  The particle phases walk (body, vertex) pairs the
    same way, a thread at a time."""
    nblk = partial_blocks(dims, lanes)
    return [[divmod(item, nblk)
             for item in range(k, num_bodies * nblk, grid)]
            for k in range(grid)]


def color_corners(dims, corner_slab, color: int, lanes) -> np.ndarray:
    """Corner vertex ids int64 [len(lanes), 4] of colour ``color``'s tets at
    tet lanes ``lanes``, as the kernel computes them (``solve_lane``): the
    colour's cubes are (px + 2 ax, py + 2 ay, pz + 2 az), lanes in C order
    over (ax, ay, az); -1 rows for lanes past the colour."""
    nx, ny, nz = dims
    t, px, py, pz = color >> 3, (color >> 2) & 1, (color >> 1) & 1, color & 1
    cwx, cwy, cwz = (nx - px + 1) // 2, (ny - py + 1) // 2, (nz - pz + 1) // 2
    lanes = np.asarray(lanes, np.int64)
    ci = px + 2 * (lanes // (cwy * cwz))
    cj = py + 2 * ((lanes // cwz) % cwy)
    ck = pz + 2 * (lanes % cwz)
    gy, gz = ny + 1, nz + 1
    out = np.stack([((ci + ((s >> 2) & 1)) * gy + (cj + ((s >> 1) & 1))) * gz
                    + (ck + (s & 1)) for s in corner_slab[t]], axis=-1)
    return np.where((lanes < cwx * cwy * cwz)[:, None], out, -1)


def frame_phases(num_substeps: int) -> int:
    """Phases of a frame, as the cooperative kernels walk them
    (``frame_phases`` of ``csrc/nh_stencil.cu``): the first predict (0),
    then per substep s the 48 colours (1 + 49 s + colour) and collide with
    the next predict (49 (s + 1)); a grid barrier between two phases."""
    return 1 + num_substeps * (COLORS + 1)


def slab_calls(num_substeps: int, one_device: bool) -> list:
    """K3s's launches of one frame on each device, as (begin, end,
    exchange): each runs phases [begin, end) of ``frame_phases``.  Where the
    mesh's slabs lie on one device, one call runs the whole frame and the
    boundary planes move inside it (write-through).  Else a call ends after
    each colour group of 4 colours (one type, one px), and ``exchange``
    says which replica of the planes shared across devices the group left
    stale: "left" after a px = 0 group (the right slab's plane 0 -> the
    left slab's plane lx), "right" after a px = 1 group, the last included,
    before collide; None after the frame's last call."""
    total = frame_phases(num_substeps)
    if one_device:
        return [(0, total, None)]
    cuts = [1 + s * (COLORS + 1) + 4 * g for s in range(num_substeps)
            for g in range(1, 13)]
    bounds = [0] + cuts + [total]
    calls = []
    for begin, end in zip(bounds, bounds[1:]):
        done = (end - 1) % (COLORS + 1) // 4  # groups of this substep run
        exchange = (None if end == total
                    else "left" if done < 12 and done % 2 == 1 else "right")
        calls.append((begin, end, exchange))
    return calls


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its arguments
    declared."""
    lib = build.load("nh_stencil", NVCC_FLAGS)
    if lib.nh_stencil_launch.argtypes is None:
        lib.nh_stencil_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [_GridNHParams, ctypes.c_void_p]
        )
        lib.nh_stencil_launch.restype = ctypes.c_int
        lib.nh_stencil_slab_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [_GridNHParams, ctypes.c_void_p]
        )
        lib.nh_stencil_slab_launch.restype = ctypes.c_int
        lib.nh_stencil_error_string.argtypes = [ctypes.c_int]
        lib.nh_stencil_error_string.restype = ctypes.c_char_p
        lib.nh_stencil_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.nh_stencil_occupancy.restype = ctypes.c_int
        lib.nh_stencil_launches_per_frame.restype = ctypes.c_int
        lib.nh_stencil_slab_launches_per_frame.restype = ctypes.c_int
        lib.nh_stencil_frame_phases.argtypes = [ctypes.c_int]
        lib.nh_stencil_frame_phases.restype = ctypes.c_int
        lib.nh_stencil_flag_ints.restype = ctypes.c_int
        if (lib.nh_stencil_launches_per_frame() != LAUNCHES_PER_FRAME
                or lib.nh_stencil_slab_launches_per_frame()
                != SLAB_LAUNCHES_PER_FRAME
                or lib.nh_stencil_frame_phases(5) != frame_phases(5)
                or lib.nh_stencil_flag_ints() != FLAG_INTS):
            raise RuntimeError("csrc/nh_stencil.cu launch counts, phases or "
                               "flag size != nh_stencil.LAUNCHES_PER_FRAME / "
                               "SLAB_LAUNCHES_PER_FRAME / frame_phases / "
                               "FLAG_INTS")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nh_stencil {what} failed: "
                           f"{lib.nh_stencil_error_string(err).decode()}")


def occupancy(device) -> tuple:
    """(blocks of K3 one SM holds at once, SMs) on ``device``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once per
    device."""
    lib = library()
    known = lib.__dict__.setdefault("occupancy", {})
    if device.index not in known:
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            _check(lib, lib.nh_stencil_occupancy(ctypes.byref(per_sm),
                                                 ctypes.byref(sms)),
                   "occupancy query")
        known[device.index] = (per_sm.value, sms.value)
    return known[device.index]


def frame_grid(device) -> int:
    """Blocks of K3's cooperative grid on ``device``: one per SM, all
    resident at once.  Raises where an SM holds none."""
    per_sm, sms = occupancy(device)
    if per_sm < 1:
        raise RuntimeError(f"an SM of {device} holds no block of K3")
    return sms


def _grid_frame_cuda(pos, vel, arr: NHGridArrays, params: PhysicsParams,
                     grab_id, grab_pos, vol_err: bool):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the NH stencil kernels run on CUDA, not {dev}")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, N = pos.shape[0], arr.num_particles
    if 3 * B * N >= 2**31:
        raise ValueError(f"{B} boxes of {N} particles overflow K3's indices")
    G = grab_id.shape[-1]
    f32 = torch.float32
    expect(pos, "pos", f32, (B, 3, N), dev)
    expect(vel, "vel", f32, (B, 3, N), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    expect(arr.inv_mass, "inv_mass", f32, (N,), dev)

    lib = library()
    grid = frame_grid(dev)
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    lanes = item_lanes(arr.dims, B, grid, vol_err)
    flags = torch.empty(B * partial_blocks(arr.dims, lanes) * FLAG_INTS,
                        dtype=torch.int32, device=dev)
    err_out = partial = None
    if vol_err:
        err_out = torch.empty((B, S), dtype=f32, device=dev)
        partial = torch.empty((B, COLORS, partial_blocks(arr.dims)),
                              dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.nh_stencil_launch(
            pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
            prev_out.data_ptr(), vel_out.data_ptr(),
            None if err_out is None else err_out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            flags.data_ptr(), arr.inv_mass.data_ptr(), grab_id.data_ptr(),
            grab_pos.data_ptr(), B, G, S, lanes, reach(arr.dims, lanes), grid,
            _frame_params(arr, params),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, err, f"cooperative launch of {grid} blocks")
    launch_count += LAUNCHES_PER_FRAME
    return pos_out, prev_out, vel_out, err_out


def grid_frame_reference(pos, vel, arr: NHGridArrays, params: PhysicsParams,
                         grab_id, grab_pos, vol_err: bool = True):
    """The frame in plain torch (``neohookean_grid.frame_reference``);
    returns (pos, prev_pos, vel, vol_err [B, num_substeps] or None)."""
    pos, prev, vel, err = neohookean_grid.frame_reference(
        pos, vel, arr, params, grab_id, grab_pos)
    return pos, prev, vel, err if vol_err else None


def grid_frame(pos, vel, arr: NHGridArrays, params: PhysicsParams, grab_id,
               grab_pos, vol_err: bool = False):
    """One frame for B boxes: pos/vel [B, 3, N], grab_id int32 [B, G],
    grab_pos [B, G, 3]; returns (pos, prev_pos, vel, vol_err [B,
    num_substeps] where asked for, else None).  CPU tensors take the plain
    path; any other device launches the CUDA kernels or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return grid_frame_reference(pos, vel, arr, params, grab_id,
                                        grab_pos, vol_err)
        return _grid_frame_cuda(pos, vel, arr, params, grab_id, grab_pos,
                                vol_err)


def make_frame_stepper(arr: NHGridArrays):
    """(pack, step, unpack, unpack_pos) over state in the kernel's layout.

    pack(state, params)            -> packed (pos, prev, vel), B = 1
    step(packed, params, controls) -> packed   (num_substeps substeps)
    unpack(packed, params)         -> SimState (identity quaternions)
    unpack_pos(packed)             -> positions [N, 3]"""

    def pack(state: SimState, params: PhysicsParams):
        del params
        return tuple(planes(x)[None]
                     for x in (state.pos, state.prev_pos, state.vel))

    def step(packed, params: PhysicsParams, controls: Controls):
        gid, gpos = common.norm_grabs(controls)
        pos, prev, vel, _ = grid_frame(packed[0], packed[2], arr, params,
                                       gid[None], gpos[None])
        return pos, prev, vel

    def unpack(packed, params: PhysicsParams) -> SimState:
        del params
        pos, prev, vel = (unplanes(x[0]) for x in packed)
        quats = pos.new_zeros((arr.num_tets, 4))
        quats[:, 3] = 1.0
        return SimState(pos=pos, prev_pos=prev, vel=vel, quats=quats)

    def unpack_pos(packed):
        return unplanes(packed[0][0])

    return pack, step, unpack, unpack_pos


def step_frame(state: SimState, arr: NHGridArrays, params: PhysicsParams,
               controls: Controls):
    """One frame through ``grid_frame`` (engine API); the state's
    quaternions are kept.  The kernels compute no volume error here, so the
    per-substep diagnostic is NaN."""
    pack, step, unpack, _ = make_frame_stepper(arr)
    new = unpack(step(pack(state, params), params, controls), params)
    return (state.replace(pos=new.pos, prev_pos=new.prev_pos, vel=new.vel),
            state.pos.new_full((params.num_substeps,), float("nan")))


def substep(state: SimState, arr: NHGridArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One substep (engine API): a frame of params with num_substeps=1."""
    del dt
    one = dataclasses.replace(params, num_substeps=1)
    new, diags = step_frame(state, arr, one, controls)
    return new, diags[0]


# -- the slab form (K3s) ---------------------------------------------------------


def make_nh_sharded_stepper(mesh, arr: NHGridArrays, axis: str = "x"):
    """(prepare, step, unprepare) for the stencil kernels over ``mesh``'s
    x-slabs (``parallel.SlabMesh``; ``axis`` names its one axis).

    prepare(state, params)         -> packed (pos, vel) slab lists
    step(packed, params, controls) -> packed  (num_substeps substeps)
    unprepare(packed, params)      -> SimState (prev_pos = pos - vel * dt)

    On CUDA slabs a frame is one cooperative launch of K3s per device
    (``csrc/nh_stencil.cu``), which writes each boundary-plane update
    through to the neighbour slab's replica, where the slabs lie on one
    device; over several devices, one launch per colour group with
    ``SlabMesh`` copies between the devices' end slabs (``slab_calls``):
    the unsharded kernel's trajectory bit for bit.  On CPU slabs it is
    ``neohookean_grid.make_nh_sharded_step``, the plain sweep with the
    exchange hook."""
    del axis
    d = mesh.size
    lx, local_dims = neohookean_grid._slab_geometry(arr.dims, d)
    local = dataclasses.replace(arr, dims=local_dims)
    inv_mass = mesh.place(neohookean_grid.slab_inv_mass(arr, d))
    twin = neohookean_grid.make_nh_sharded_step(mesh, arr)

    def prepare(state: SimState, params: PhysicsParams):
        del params
        return neohookean_grid.nh_prepare(state, arr, mesh)

    def step(packed, params: PhysicsParams, controls: Controls):
        with span(_SPAN):
            if all(p.device.type == "cpu" for p in packed[0]):
                return twin(packed, params, controls)[0]
            return _slab_frame_cuda(packed, inv_mass, mesh, local, lx, params,
                                    controls)

    def unprepare(packed, params: PhysicsParams) -> SimState:
        return neohookean_grid.nh_unprepare(packed, arr, d, params)

    return prepare, step, unprepare


def _slab_frame_cuda(packed, inv_mass, mesh, local: NHGridArrays, lx: int,
                     params: PhysicsParams, controls: Controls):
    global segment_launch_count
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    lib = library()
    par = _frame_params(local, params)
    n = local.num_particles
    gyz = (local.dims[1] + 1) * (local.dims[2] + 1)
    gid, gpos = common.norm_grabs(controls)
    groups = device_groups(mesh, pos=packed[0], vel=packed[1], im=inv_mass)
    for g in groups:
        k, dev = g["k"], g["dev"]
        if 3 * k * n >= 2**31:
            raise ValueError(f"{k} slabs of {n} particles overflow K3s's "
                             "indices")
        expect(g["pos"], "pos", torch.float32, (k, 3, n), dev)
        expect(g["vel"], "vel", torch.float32, (k, 3, n), dev)
        expect(g["im"], "inv_mass", torch.float32, (k, n), dev)
        g.update(gid=gid.to(dev).contiguous(), gpos=gpos.to(dev).contiguous(),
                 pos_out=torch.empty_like(g["pos"]),
                 prev_out=torch.empty_like(g["pos"]),
                 vel_out=torch.empty_like(g["pos"]), grid=frame_grid(dev))
    calls = slab_calls(S, len(groups) == 1)
    if len(groups) > 1:  # the planes shared across devices
        cuts = mesh.device_cuts()
        slabs = [x for g in groups for x in ungroup(g["pos_out"])]
        lo = [plane(x, 0, gyz) for x in slabs]
        hi = [plane(x, lx, gyz) for x in slabs]
    for begin, end, exchange in calls:
        for g in groups:
            with torch.cuda.device(g["dev"]):
                err = lib.nh_stencil_slab_launch(
                    g["pos"].data_ptr(), g["vel"].data_ptr(),
                    g["pos_out"].data_ptr(), g["prev_out"].data_ptr(),
                    g["vel_out"].data_ptr(), g["im"].data_ptr(),
                    g["gid"].data_ptr(), g["gpos"].data_ptr(), g["k"],
                    g["gid"].shape[0], S, g["first"] * lx * gyz, lx * gyz,
                    begin, end, g["grid"], par, g["stream"])
            _check(lib, err, f"cooperative slab launch of {g['grid']} blocks")
        if exchange == "left":
            mesh.send_left(lo, hi, pairs=cuts)  # right's plane 0 -> plane lx
        elif exchange == "right":
            mesh.send_right(hi, lo, pairs=cuts)  # left's plane lx -> plane 0
    segment_launch_count += len(calls) * len(groups)
    return ([x for g in groups for x in ungroup(g["pos_out"])],
            [x for g in groups for x in ungroup(g["vel_out"])])
