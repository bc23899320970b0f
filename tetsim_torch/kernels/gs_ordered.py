"""Exact-order Gauss-Seidel frame for 8 bodies of one mesh (counterpart of
``tetsim_tpu/kernels/gs_ordered.py``).

The ordered level schedule reproduces the reference's sequential
constraint order: for the dragon, 703 dependent levels.  Levels are split
into sub-levels of at most 32 vertex-disjoint tets and packed, in order,
into windows whose particle union fits ``w_lanes`` lanes
(``build_ordered_schedule``, the JAX package's tables without their
8-sublane repeat).  ``ordered_frame`` runs one whole frame for a batch: on
CUDA tensors one launch of the hand-written kernel ``csrc/gs_ordered.cu``,
on CPU tensors ``ordered_frame_reference``, the same frame in plain torch
with the tet projection of ``solvers/neohookean.py``.  ``launch_count``
counts the kernel's launches.

Predict multiplies the velocity by the movable mask ``movw`` and the
velocity update multiplies by 1 / dt, as the JAX kernel does (the
Neo-Hookean engine of ``solvers/`` gates with ``inv_mass > 0`` and
divides by dt).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..mesh import TetMesh, level_schedule, rest_state
from ..params import PhysicsParams
from ..solvers import common, neohookean
from ..spans import kernel, span
from . import build
from .batch import SMEM_LIMIT, FusedBatch, expect

CW = 32  # tets per sub-level (4 corners x 32 = one 128-slot corner block)
THREADS = 256  # threads per block, as kThreads in csrc/gs_ordered.cu
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)
NUM_BODIES = 8  # the batch of OrderedGSBody, as in the JAX package

launch_count = 0  # launches of the CUDA kernel since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


# -- host schedule -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OrderedSchedule:
    uidx: np.ndarray  # i32 [NW, W]         window refill: particle per lane
    xinv: np.ndarray  # i32 [NW, R]         write-back: window lane or -1
    lids: np.ndarray  # i32 [NW, Lm, 128]   corner slot -> window lane
    winv: np.ndarray  # i32 [NW, Lm, W]     window lane -> corner slot or -1
    cons: np.ndarray  # f32 [NW, Lm, 14, 32] rows 0-8 irp, 9 irv, 10-13 imc
    movw: np.ndarray  # f32 [R]             movable mask
    nlev: np.ndarray  # i32 [NW]            live sub-levels per window
    num_windows: int
    l_max: int
    w_lanes: int
    rows: int  # R (128-padded particle lanes)
    num_particles: int
    num_tets: int
    num_levels: int  # sub-levels in all
    verts: np.ndarray


def build_ordered_schedule(mesh: TetMesh, density: float = 1000.0,
                           pinned=None, w_lanes: int = 384) -> OrderedSchedule:
    """The ordered schedule in windows: consecutive sub-levels while their
    particle union fits ``w_lanes`` lanes.  A sub-level's corner c of tet t
    sits in slot c * 32 + t."""
    ir, irv_t, _, im, _ = rest_state(mesh, density, pinned=pinned)
    tets = mesh.tets
    n, m = mesh.num_particles, mesh.num_tets
    r = -(-n // 128) * 128

    colors = level_schedule(tets, n)
    levels = []  # each: <= 32 global tet ids, in order
    for lv in range(int(colors.max()) + 1):
        tl = np.nonzero(colors == lv)[0]
        for i in range(0, len(tl), CW):
            levels.append(tl[i:i + CW])

    windows = []  # (sub-levels, sorted particle union)
    cur, cur_union = [], set()
    for lv in levels:
        u = set(int(v) for v in tets[lv].reshape(-1))
        if cur and len(cur_union | u) > w_lanes:
            windows.append((cur, np.asarray(sorted(cur_union), np.int64)))
            cur, cur_union = [], set()
        cur.append(lv)
        cur_union |= u
    if cur:
        windows.append((cur, np.asarray(sorted(cur_union), np.int64)))
    nw = len(windows)
    lm = max(len(w[0]) for w in windows)

    uidx = np.zeros((nw, w_lanes), np.int32)
    xinv = np.full((nw, r), -1, np.int32)
    lids = np.zeros((nw, lm, 4 * CW), np.int32)
    winv = np.full((nw, lm, w_lanes), -1, np.int32)
    cons = np.zeros((nw, lm, 14, CW), np.float32)
    for w, (lvls, union) in enumerate(windows):
        uidx[w, :len(union)] = union
        xinv[w, union] = np.arange(len(union))
        lut = np.full(n, -1, np.int64)
        lut[union] = np.arange(len(union))
        for lv, tl in enumerate(lvls):
            k = len(tl)
            corners = lut[tets[tl]]  # [k, 4] window lanes
            for c in range(4):
                lids[w, lv, c * CW:c * CW + k] = corners[:, c]
                winv[w, lv, corners[:, c]] = c * CW + np.arange(k)
            cons[w, lv, :9, :k] = ir[tl].reshape(k, 9).T
            cons[w, lv, 9, :k] = irv_t[tl]
            cons[w, lv, 10:14, :k] = im[tets[tl]].T

    movw = np.zeros(r, np.float32)
    movw[:n] = (im > 0.0).astype(np.float32)
    return OrderedSchedule(
        uidx=uidx, xinv=xinv, lids=lids, winv=winv, cons=cons, movw=movw,
        nlev=np.asarray([len(w[0]) for w in windows], np.int32),
        num_windows=nw, l_max=lm, w_lanes=w_lanes, rows=r, num_particles=n,
        num_tets=m, num_levels=len(levels),
        verts=mesh.verts.astype(np.float32),
    )


@dataclasses.dataclass
class OrderedTables:
    """An ``OrderedSchedule`` on one device: the windowed tables the plain
    twin walks, and the kernel's flat form of the same sub-levels in the
    same order (``sub_ids`` [S, 4, 32], global corner ids from
    ``uidx[lids]``, -1 on padded lanes; ``sub_cons`` [S, 14, 32])."""

    sched: OrderedSchedule
    uidx: torch.Tensor
    xinv: torch.Tensor
    lids: torch.Tensor
    winv: torch.Tensor
    cons: torch.Tensor
    movw: torch.Tensor  # [N]
    sub_ids: torch.Tensor
    sub_cons: torch.Tensor

    @property
    def num_particles(self) -> int:
        return self.sched.num_particles


def ordered_tables(sched: OrderedSchedule, device) -> OrderedTables:
    ids, cons = [], []
    for w in range(sched.num_windows):
        union = sched.uidx[w]
        for lv in range(sched.nlev[w]):
            k = int((sched.winv[w, lv] >= 0).sum()) // 4  # tets of the level
            slots = sched.lids[w, lv].reshape(4, CW)
            ids.append(np.where(np.arange(CW) < k, union[slots], -1))
            cons.append(sched.cons[w, lv])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    n = sched.num_particles
    return OrderedTables(
        sched=sched, uidx=t(sched.uidx.astype(np.int64)),
        xinv=t(sched.xinv[:, :n].astype(np.int64)),
        lids=t(sched.lids.astype(np.int64)),
        winv=t(sched.winv.astype(np.int64)), cons=t(sched.cons),
        movw=t(sched.movw[:n]),
        sub_ids=t(np.stack(ids).astype(np.int32)),
        sub_cons=t(np.stack(cons).astype(np.float32)),
    )


# -- bounds and shared memory ---------------------------------------------------


def smem_bytes(num_particles: int) -> int:
    """Shared memory of one block: the 9 particle planes."""
    return 4 * 9 * num_particles


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the exact-order frame kernel keeps a body in shared memory: "
            f"{num_particles} particles need {need} bytes, a Hopper block has "
            f"{SMEM_LIMIT} (at most {SMEM_LIMIT // 36} particles)"
        )


def frame_flops(sched: OrderedSchedule, params: PhysicsParams,
                num_bodies: int) -> int:
    """Floating-point operations of one frame, counted from
    ``csrc/gs_ordered.cu`` as ``gs_fused.frame_flops`` counts K1's (adds,
    multiplies, divides, square roots; compares, clamps, selects and the
    data-dependent friction are not counted): 420 per tet and substep for
    both constraint projections, 16 per particle and substep (predict with
    the movable mask, velocity)."""
    return num_bodies * params.num_substeps * (
        420 * sched.num_tets + 16 * sched.num_particles)


def frame_bytes(sched: OrderedSchedule, num_bodies: int, num_grabs: int) -> int:
    """Bytes a frame must move: each input read once (pos, vel, a tet's
    corner ids and 14 constants, the movable mask, grabs), each output
    written once (pos, prev, vel)."""
    n = sched.num_particles
    return (num_bodies * (5 * 12 * n + 16 * num_grabs)
            + 72 * sched.num_tets + 4 * n)


# -- the frame ------------------------------------------------------------------


class _OrderedParams(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float), ("gdt", ctypes.c_float),
        ("inv_dt", ctypes.c_float), ("k_fric", ctypes.c_float),
        ("dev_scale", ctypes.c_float), ("vol_scale", ctypes.c_float),
        ("gamma", ctypes.c_float),
        ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
    ]


def _ordered_params(params: PhysicsParams) -> _OrderedParams:
    """The frame's scalars in f32, with the plain twin's operation order."""
    dt = params.dt
    dt2 = dt * dt
    return _OrderedParams(
        dt, params.gravity * dt, np.float32(1.0) / dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        params.dev_compliance / dt2, params.vol_compliance / dt2,
        params.gamma,
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
    )


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments declared."""
    lib = build.load("gs_ordered", NVCC_FLAGS)
    if lib.gs_ordered_launch.argtypes is None:
        lib.gs_ordered_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [_OrderedParams, ctypes.c_void_p]
        )
        lib.gs_ordered_launch.restype = ctypes.c_int
        lib.gs_ordered_error_string.argtypes = [ctypes.c_int]
        lib.gs_ordered_error_string.restype = ctypes.c_char_p
        lib.gs_ordered_threads.restype = ctypes.c_int
        if lib.gs_ordered_threads() != THREADS:
            raise RuntimeError("csrc/gs_ordered.cu kThreads != gs_ordered.THREADS")
    return lib


def _ordered_frame_cuda(pos, vel, tab: OrderedTables, params: PhysicsParams,
                        grab_id, grab_pos):
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the exact-order frame kernel runs on CUDA, not {dev}")
    B, N = pos.shape[0], tab.num_particles
    S = tab.sub_ids.shape[0]
    G = grab_id.shape[-1]
    check_fits(N)
    f32 = torch.float32
    expect(pos, "pos", f32, (B, N, 3), dev)
    expect(vel, "vel", f32, (B, N, 3), dev)
    expect(grab_id, "grab_id", torch.int32, (B, G), dev)
    expect(grab_pos, "grab_pos", f32, (B, G, 3), dev)
    expect(tab.sub_ids, "sub_ids", torch.int32, (S, 4, CW), dev)
    expect(tab.sub_cons, "sub_cons", f32, (S, 14, CW), dev)
    expect(tab.movw, "movw", f32, (N,), dev)
    if S < 1:
        raise ValueError("the exact-order frame kernel needs a sub-level")

    lib = library()
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.gs_ordered_launch(
            pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
            prev_out.data_ptr(), vel_out.data_ptr(), tab.sub_ids.data_ptr(),
            tab.sub_cons.data_ptr(), tab.movw.data_ptr(), grab_id.data_ptr(),
            grab_pos.data_ptr(), B, N, S, G, params.num_substeps,
            _ordered_params(params), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"gs_ordered launch failed: {lib.gs_ordered_error_string(err).decode()}"
        )
    launch_count += 1
    return pos_out, prev_out, vel_out


def ordered_frame_reference(pos, vel, tab: OrderedTables,
                            params: PhysicsParams, grab_id, grab_pos):
    """The frame in plain torch on any device: pos/vel [B,N,3], grabs
    grab_id int32 [B,G] and grab_pos [B,G,3].  Per substep: predict, then
    per window the working set's lanes gathered from the positions, per
    live sub-level its corners gathered, both constraints projected and
    the corners scattered back, the window written back; then clamp,
    ground, grab and velocity.  Returns (pos, prev_pos, vel)."""
    s = tab.sched
    dt = params.dt
    gdt = params.gravity * dt
    inv_dt = np.float32(1.0) / dt
    mov = tab.movw[:, None]
    prev = pos
    for _ in range(params.num_substeps):
        vel = vel.clone()
        vel[..., 1] += gdt
        vel = vel * mov
        prev = pos
        pos = pos + vel * dt
        for w in range(s.num_windows):
            wp = pos[:, tab.uidx[w]]  # [B, W, 3]
            for lv in range(s.nlev[w]):
                c = tab.cons[w, lv]
                p = wp[:, tab.lids[w, lv]].unflatten(1, (4, CW)).transpose(1, 2)
                delta, _ = neohookean.solve_tet_batch(
                    p, c[:9].T.reshape(CW, 3, 3), c[9], c[10:14].T, dt, params)
                moved = (p + delta).transpose(1, 2).flatten(1, 2)  # slot order
                inv = tab.winv[w, lv]
                wp = torch.where((inv >= 0)[:, None],
                                 moved[:, inv.clamp(min=0)], wp)
            xi = tab.xinv[w]
            pos = torch.where((xi >= 0)[:, None], wp[:, xi.clamp(min=0)], pos)
        pos = common.collide(pos, prev, dt, params)
        pos = common.grab_override(pos, grab_id, grab_pos)
        vel = (pos - prev) * inv_dt
    return pos, prev, vel


def ordered_frame(pos, vel, tab: OrderedTables, params: PhysicsParams,
                  grab_id, grab_pos):
    """One frame for B bodies (see ``ordered_frame_reference`` for shapes).
    CPU tensors take the plain twin; any other device launches the CUDA
    kernel or raises."""
    with span(_SPAN):
        if pos.device.type == "cpu":
            return ordered_frame_reference(pos, vel, tab, params, grab_id,
                                           grab_pos)
        return _ordered_frame_cuda(pos, vel, tab, params, grab_id, grab_pos)


class OrderedGSBody(FusedBatch):
    """8 bodies of one mesh stepped with the exact reference GS order, one
    launch per frame on CUDA (state and per-body grab API: ``FusedBatch``);
    the trajectory follows ``solvers/golden.py`` to f32 rounding."""

    def __init__(self, mesh: TetMesh, density: float = 1000.0, pinned=None,
                 w_lanes: int = 384, jitter: float = 0.0, seed: int = 0,
                 device="cuda"):
        check_fits(mesh.num_particles)
        super().__init__(mesh, NUM_BODIES, jitter, seed, device)
        self.sched = build_ordered_schedule(mesh, density=density,
                                            pinned=pinned, w_lanes=w_lanes)
        self.tables = ordered_tables(self.sched, self.device)

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every body by ``frames`` frames (no sync)."""
        for _ in range(frames):
            self.pos, self.prev_pos, self.vel = ordered_frame(
                self.pos, self.vel, self.tables, params, self.grab_id,
                self.grab_pos)
