"""Neo-Hookean Gauss-Seidel on one large unstructured mesh cut into pieces
(counterpart of ``tetsim_tpu/kernels/nh_pieces.py``): the ``nh_pieces``
engine, the reference's two-constraint XPBD projection on meshes too large
and too irregular for the fused frame kernel or the grid stencils.

The mesh is cut as ``polar_pieces`` cuts it (RCB pieces, local lanes in RCM
order, optionally banded).  Within a piece the solve is real Gauss-Seidel:
the piece's tets are greedy-coloured and each colour is cut into sub-levels
of at most 128 tets, which share no vertex, so a sub-level is solved at
once.  Across pieces the coupling is Jacobi, once per substep: each shared
particle's final position is its predicted position plus the mean of its
per-piece deltas (``_complete_boundary``; a sum double-corrects and
explodes within about 10 substeps).  Every other phase is elementwise, so
a particle's instances stay bitwise equal.

``nh_pieces_frame`` runs a whole frame: on CUDA tensors it launches the
kernel of ``csrc/nh_pieces.cu`` once, a cooperative launch whose blocks
sweep the pieces and whose threads then complete, collide, grab and set
the velocity of every lane, a grid barrier between the two phases of each
substep; on CPU tensors it runs ``nh_pieces_frame_reference``, the
substep loop in plain torch with the sweep ``nh_pieces_solve_reference``
on ``solvers/neohookean.solve_tet_batch``.  ``launch_count`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..mesh import TetMesh, greedy_color, rest_state
from ..params import PhysicsParams
from ..state import SimState, Controls
from ..solvers import common, neohookean
from ..spans import kernel, span
from . import build
from .batch import SMEM_LIMIT, cached_params, expect
from .polar_pieces import (_rcm_particle_order, _round_up, band_locals,
                           collide_planes, completion_tables, grab_planes,
                           owned, partner_tables, predict_planes, rcb_partition,
                           to_device, to_local, velocity_planes)

CW = 128  # tets per sub-level, the kernel's threads per block
LAUNCHES_PER_FRAME = 1  # as nh_pieces_launches_per_frame()

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


# -- host-side partition and per-piece coloured GS schedule ------------------


@dataclasses.dataclass(frozen=True)
class NHPiecesSchedule:
    """Numpy tables of the Neo-Hookean pieces engine."""

    lids: np.ndarray   # i32 [L, B, 4*CW]  sub-level corner slot -> local lane
    winv: np.ndarray   # i32 [L, B, rp]    lane -> sub-level corner slot or -1
    cons: np.ndarray   # f32 [L, B, 14, CW] rows 0-8 irp, 9 irv, 10-13 imc
    g2l: np.ndarray    # i32 [B, rp]       local lane -> global pid (N pad)
    owner_inst: np.ndarray   # i32 [N]     first instance (piece*rp + lane)
    bnd_inst: np.ndarray     # i32 [Jmax, Sb]
    tier_counts: tuple
    bnd_count: np.ndarray    # f32 [Sb]    instances per boundary row
    lane_bnd: np.ndarray     # i32 [B*rp]  compact boundary row or -1
    pidx: np.ndarray         # i32 [B, r2] J=2 partner flat lane (self pad)
    is2: np.ndarray          # bool [B, r2] lane holds a J=2 particle
    inv_mass: np.ndarray     # f32 [N]
    num_particles: int
    num_tets: int
    n_pieces: int
    B: int
    rp: int
    rb: int    # end of the shared-lane bands (rp without banding)
    r2: int    # end of the J=2 band (0 without banding)
    l_max: int


def build_nh_pieces_schedule(mesh: TetMesh, density: float = 1000.0,
                             tets_per_piece: int = 2048, pinned=None,
                             boundary_prefix: bool = False) -> NHPiecesSchedule:
    ir, irv_t, _, im, _ = rest_state(mesh, density, pinned=pinned)
    tets = mesh.tets
    n = mesh.num_particles

    order = _rcm_particle_order(tets, n)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    parts, n_pieces = rcb_partition(mesh, tets_per_piece)
    b_pad = _round_up(n_pieces, 8)

    # local particle sets and per-piece sub-level lists
    pieces = []  # (local particles, [sub-level tet-id arrays])
    rp = l_max = 0
    for te in parts:
        locals_ = np.unique(tets[te].reshape(-1))
        locals_ = locals_[np.argsort(rank[locals_], kind="stable")]
        rp = max(rp, len(locals_))
        colors = greedy_color(tets[te], n)
        levels = []
        for c in range(int(colors.max()) + 1 if len(te) else 0):
            tl = te[colors == c]
            for i in range(0, len(tl), CW):
                levels.append(tl[i:i + CW])
        l_max = max(l_max, len(levels))
        pieces.append((locals_, levels))
    rp = _round_up(rp, 128)

    rb, r2 = rp, 0
    if boundary_prefix:
        loc, pos, r2, rb, rp = band_locals([locals_ for locals_, _ in pieces], n)
        pieces = [(loc[i], pos[i], levels)
                  for i, (_, levels) in enumerate(pieces)]
    else:
        pieces = [(locals_, np.arange(len(locals_)), levels)
                  for locals_, levels in pieces]

    lids = np.zeros((l_max, b_pad, 4 * CW), np.int32)
    winv = np.full((l_max, b_pad, rp), -1, np.int32)
    cons = np.zeros((l_max, b_pad, 14, CW), np.float32)
    g2l = np.full((b_pad, rp), n, np.int32)
    instances = [[] for _ in range(n)]

    lut = np.empty(n, np.int64)
    for p, (locals_, lanepos, levels) in enumerate(pieces):
        g2l[p, lanepos] = locals_
        lut[locals_] = lanepos
        for i, g in zip(lanepos, locals_):
            instances[int(g)].append(p * rp + int(i))
        for l, tl in enumerate(levels):
            # within a sub-level, tets sorted by their first local corner
            lt = lut[tets[tl]]
            perm = np.argsort(lt[:, 0], kind="stable")
            tl, lt = tl[perm], lt[perm]
            k = len(tl)
            for c in range(4):
                lids[l, p, c * CW:c * CW + k] = lt[:, c]
                winv[l, p, lt[:, c]] = c * CW + np.arange(k)
            irp = ir[tl]  # [k, 3, 3]
            for rr in range(3):
                for cc in range(3):
                    cons[l, p, rr * 3 + cc, :k] = irp[:, rr, cc]
            cons[l, p, 9, :k] = irv_t[tl]
            cons[l, p, 10:14, :k] = im[tets[tl]].T

    owner_inst, bnd_inst, tier_counts, lane_bnd = completion_tables(
        instances, n, b_pad * rp, exclude_pairs=bool(r2))
    pidx, is2 = partner_tables(instances, n, b_pad, rp, r2)
    bnd_count = np.ones(bnd_inst.shape[1], np.float32)
    for j, c in enumerate(tier_counts):
        if j > 0:
            bnd_count[:c] += 1.0

    return NHPiecesSchedule(
        lids=lids, winv=winv, cons=cons, g2l=g2l, owner_inst=owner_inst,
        bnd_inst=bnd_inst, tier_counts=tier_counts, bnd_count=bnd_count,
        lane_bnd=lane_bnd, pidx=pidx, is2=is2,
        inv_mass=np.asarray(im, np.float32), num_particles=n,
        num_tets=mesh.num_tets, n_pieces=n_pieces, B=b_pad, rp=rp, rb=rb,
        r2=r2, l_max=l_max,
    )


def live_counts(lids: np.ndarray, winv: np.ndarray) -> np.ndarray:
    """int32 [L, B]: the live tets of each sub-level of each piece.  They
    fill slots [0, k): slot t is live when the lane of its corner 0 maps
    back to it through ``winv``; a padded slot reads lane 0 and must not
    write it."""
    first = np.take_along_axis(winv, lids[:, :, :CW].astype(np.int64), axis=2)
    return (first == np.arange(CW)).sum(axis=2).astype(np.int32)


# -- device tables -------------------------------------------------------------


@dataclasses.dataclass
class NHPiecesArrays:
    """The Neo-Hookean pieces engine's tables as tensors on one device, and
    their static shape."""

    num_particles: int
    num_tets: int
    B: int
    rp: int
    rb: int
    r2: int
    l_max: int
    tier_counts: tuple
    # the sweep's tables (the schedule's winv stays on the host: the live
    # slot counts say which slots write back)
    lids: torch.Tensor  # i32 [L, B, 4*CW]
    cons: torch.Tensor  # f32 [L, B, 14, CW]
    n_live: torch.Tensor  # i32 [L, B] live slots per sub-level, a prefix
    # completion and conversion maps
    g2l_flat: torch.Tensor  # i32 [B*rp]
    owner_inst: torch.Tensor  # i32 [N]
    bnd_inst: torch.Tensor  # i32 [Jmax, Sb]
    bnd_count: torch.Tensor  # f32 [Sb]
    lane_bnd: torch.Tensor  # i32 [B*rp] (-1 interior)
    pidx: torch.Tensor  # i32 [B, r2]
    is2: torch.Tensor  # bool [B, r2]
    movw_l: torch.Tensor  # f32 [B, rp]
    pid_l: torch.Tensor  # i32 [B, rp]
    inv_mass: torch.Tensor  # f32 [N]

    @property
    def device(self) -> torch.device:
        return self.lids.device

    def to(self, device) -> "NHPiecesArrays":
        return to_device(self, device)


def build_nh_pieces_arrays(mesh: TetMesh, density: float = 1000.0,
                           tets_per_piece: int = 2048, pinned=None,
                           boundary_prefix: bool = False, *,
                           device) -> NHPiecesArrays:
    s = build_nh_pieces_schedule(mesh, density, tets_per_piece, pinned,
                                 boundary_prefix)
    movw_pad = np.concatenate([(s.inv_mass > 0.0).astype(np.float32),
                               np.zeros(1, np.float32)])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return NHPiecesArrays(
        num_particles=s.num_particles, num_tets=s.num_tets, B=s.B, rp=s.rp,
        rb=s.rb, r2=s.r2, l_max=s.l_max, tier_counts=s.tier_counts,
        lids=t(s.lids), cons=t(s.cons), n_live=t(live_counts(s.lids, s.winv)),
        g2l_flat=t(s.g2l.reshape(-1)), owner_inst=t(s.owner_inst),
        bnd_inst=t(s.bnd_inst), bnd_count=t(s.bnd_count),
        lane_bnd=t(s.lane_bnd), pidx=t(s.pidx), is2=t(s.is2),
        movw_l=t(movw_pad[s.g2l]), pid_l=t(s.g2l), inv_mass=t(s.inv_mass),
    )


# -- the frame kernel and its plain twin ----------------------------------------


def smem_bytes(rp: int) -> int:
    """Shared memory of one block: a piece's three position planes."""
    return 12 * rp


def frame_flops(arr: NHPiecesArrays, params: PhysicsParams) -> int:
    """Floating-point operations of the sweep in one frame, counted as for
    ``gs_fused.frame_flops`` (the projection is the same, without its
    vol_err sum): 420 per tet and substep.  Padded slots (half of ``cons``
    at 987,090 tets) carry no work and are not counted, nor are the lane
    phase's few operations per lane."""
    return params.num_substeps * 420 * arr.num_tets


def frame_bytes(arr: NHPiecesArrays, params: PhysicsParams) -> int:
    """Bytes a frame must move, per substep: the six state planes read and
    written once, movw, pid and lane_bnd read once (15 planes of B*rp
    floats), the live counts, per live tet its 4 corner lanes and 14
    constants (72 bytes; padded slots are not read), pidx and is2 over the
    J=2 band (5 bytes a lane), the partner's swept and predicted position
    for each J=2 lane (24 bytes), and for each lane of a boundary row its
    count (4 bytes) and, per instance of the row, the instance index and
    its six planes (28 bytes).  The frame kernel moves 15 planes more than
    this (``design_bytes``)."""
    lanes = arr.B * arr.rp
    tier = arr.lane_bnd >= 0
    count = arr.bnd_count[arr.lane_bnd[tier].long()]
    pairs = int(arr.is2.sum())
    per_substep = (4 * 15 * lanes + 4 * arr.l_max * arr.B
                   + 72 * arr.num_tets + 5 * arr.B * arr.r2 + 24 * pairs
                   + 4 * int(tier.sum()) + 28 * int(count.sum()))
    return params.num_substeps * per_substep


def design_bytes(arr: NHPiecesArrays, params: PhysicsParams) -> int:
    """Bytes the frame kernel moves on top of ``frame_bytes``, per
    substep: the piece phase writes the predicted and swept planes to the
    scratch and the lane phase reads its lane's back (12 planes of B*rp
    floats), and the lane phase reads the substep's start positions a
    second time (3 planes)."""
    return params.num_substeps * 4 * 15 * arr.B * arr.rp


class _NHPiecesParams(ctypes.Structure):
    _fields_ = [("dt", ctypes.c_float), ("gdt", ctypes.c_float),
                ("k_fric", ctypes.c_float),
                ("wmin", ctypes.c_float * 3), ("wmax", ctypes.c_float * 3),
                ("dev_scale", ctypes.c_float), ("vol_scale", ctypes.c_float),
                ("gamma", ctypes.c_float)]


class _NHPiecesInputs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * 6)]


def _frame_params(params: PhysicsParams) -> _NHPiecesParams:
    """The frame's scalars in f32, with the plain path's operation order."""
    dt = params.dt
    dt2 = dt * dt
    return _NHPiecesParams(
        dt, params.gravity * dt,
        np.minimum(np.float32(1.0), dt * params.friction),
        (ctypes.c_float * 3)(*params.world_min),
        (ctypes.c_float * 3)(*params.world_max),
        params.dev_compliance / dt2, params.vol_compliance / dt2,
        params.gamma)


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments
    declared."""
    lib = build.load("nh_pieces")
    if lib.nh_pieces_frame_launch.argtypes is None:
        lib.nh_pieces_frame_launch.argtypes = (
            [_NHPiecesInputs] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
            + [_NHPiecesParams, ctypes.c_void_p])
        lib.nh_pieces_frame_launch.restype = ctypes.c_int
        lib.nh_pieces_occupancy.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2)
        lib.nh_pieces_occupancy.restype = ctypes.c_int
        lib.nh_pieces_error_string.argtypes = [ctypes.c_int]
        lib.nh_pieces_error_string.restype = ctypes.c_char_p
        lib.nh_pieces_slots.restype = ctypes.c_int
        lib.nh_pieces_launches_per_frame.restype = ctypes.c_int
        if (lib.nh_pieces_slots() != CW
                or lib.nh_pieces_launches_per_frame() != LAUNCHES_PER_FRAME):
            raise RuntimeError("csrc/nh_pieces.cu kSlots or launches per "
                               "frame != nh_pieces.CW / LAUNCHES_PER_FRAME")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nh_pieces {what} failed: "
                           f"{lib.nh_pieces_error_string(err).decode()}")


def frame_grid(device, rp: int) -> int:
    """Blocks of the frame kernel's cooperative grid on ``device`` for
    pieces of ``rp`` lanes: every block the SMs hold at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the piece's shared
    memory), asked once per device and rp.  Raises where an SM holds
    none."""
    lib = library()
    known = lib.__dict__.setdefault("grids", {})
    if (device.index, rp) not in known:
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            _check(lib, lib.nh_pieces_occupancy(rp, ctypes.byref(per_sm),
                                                ctypes.byref(sms)),
                   "occupancy query")
        if per_sm.value < 1:
            raise RuntimeError(f"an SM of {device} holds no block of the "
                               f"nh_pieces frame kernel at rp={rp}")
        known[device.index, rp] = per_sm.value * sms.value
    return known[device.index, rp]


def _frame_cuda(packed, arr: NHPiecesArrays, params: PhysicsParams, gid,
                gpos):
    global launch_count
    dev = packed[0].device
    if dev.type != "cuda":
        raise ValueError(f"the NH pieces kernel runs on CUDA, not {dev}")
    S = params.num_substeps
    if S < 1:
        raise ValueError(f"num_substeps must be at least 1, got {S}")
    B, rp, L, r2 = arr.B, arr.rp, arr.l_max, arr.r2
    if smem_bytes(rp) > SMEM_LIMIT:
        raise ValueError(
            f"the NH pieces kernel keeps a piece's planes in shared memory: "
            f"rp={rp} lanes need {smem_bytes(rp)} bytes, a Hopper block has "
            f"{SMEM_LIMIT}; build with a smaller tets_per_piece")
    if 6 * B * rp >= 2**31:
        raise ValueError(f"{B} pieces of {rp} lanes overflow the kernel's "
                         "indices")
    f32, i32 = torch.float32, torch.int32
    for name, plane in zip(("lx", "ly", "lz", "vx", "vy", "vz"), packed):
        expect(plane, name, f32, (B, rp), dev)
    expect(arr.lids, "lids", i32, (L, B, 4 * CW), dev)
    expect(arr.cons, "cons", f32, (L, B, 14, CW), dev)
    expect(arr.n_live, "n_live", i32, (L, B), dev)
    expect(arr.movw_l, "movw_l", f32, (B, rp), dev)
    expect(arr.pid_l, "pid_l", i32, (B, rp), dev)
    expect(arr.pidx, "pidx", i32, (B, r2), dev)
    expect(arr.is2, "is2", torch.bool, (B, r2), dev)
    expect(arr.lane_bnd, "lane_bnd", i32, (B * rp,), dev)
    sb = arr.bnd_inst.shape[1]
    expect(arr.bnd_inst, "bnd_inst", i32, (arr.bnd_inst.shape[0], sb), dev)
    expect(arr.bnd_count, "bnd_count", f32, (sb,), dev)
    G = gid.shape[0]
    gid, gpos = gid.to(dev, i32).contiguous(), gpos.to(dev, f32).contiguous()
    expect(gpos, "gpos", f32, (G, 3), dev)

    lib = library()
    grid = frame_grid(dev, rp)
    out = torch.empty((6, B, rp), dtype=f32, device=dev)
    scratch = torch.empty((6, B, rp), dtype=f32, device=dev)
    inputs = _NHPiecesInputs((ctypes.c_void_p * 6)(
        *(p.data_ptr() for p in packed)))
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.nh_pieces_frame_launch(
            inputs, out.data_ptr(), scratch.data_ptr(), arr.lids.data_ptr(),
            arr.cons.data_ptr(), arr.n_live.data_ptr(),
            arr.movw_l.data_ptr(), arr.pid_l.data_ptr(),
            arr.pidx.data_ptr() if r2 else None,
            arr.is2.data_ptr() if r2 else None, arr.lane_bnd.data_ptr(),
            arr.bnd_inst.data_ptr(), arr.bnd_count.data_ptr(),
            gid.data_ptr(), gpos.data_ptr(), B, rp, L, r2, sb, G, S, grid,
            cached_params(params, _frame_params),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, f"cooperative launch of {grid} blocks")
    launch_count += LAUNCHES_PER_FRAME
    return tuple(out.unbind(0))


def nh_pieces_solve_reference(px, py, pz, arr: NHPiecesArrays,
                              params: PhysicsParams):
    """The per-piece sweep in plain torch on positions px/py/pz [B, rp]:
    each sub-level gathers its corners by ``lids``, projects them with
    ``solve_tet_batch`` (p + (d_dev + d_vol)) and scatters its live slots,
    the first ``n_live``, back through ``lids``; padded slots write a spare
    lane past rp, which is dropped.  Returns the three swept planes."""
    B, rp = arr.B, arr.rp
    pos = torch.stack([px, py, pz], dim=-1)  # [B, rp, 3]
    pos = torch.cat([pos, pos.new_zeros((B, 1, 3))], dim=1)  # + spare lane
    slot = torch.arange(CW, device=pos.device)
    for ids, cons, n in zip(arr.lids.unbind(0), arr.cons.unbind(0),
                            arr.n_live.unbind(0)):
        idx = ids.long()[..., None].expand(-1, -1, 3)
        p = torch.gather(pos, 1, idx).reshape(B, 4, CW, 3).transpose(1, 2)
        irp = cons[:, :9].transpose(1, 2).reshape(B, CW, 3, 3)
        imc = cons[:, 10:14].transpose(1, 2)
        delta, _ = neohookean.solve_tet_batch(p, irp, cons[:, 9], imc,
                                              params.dt, params)
        new = (p + delta).transpose(1, 2).reshape(B, 4 * CW, 3)
        live = (slot < n[:, None]).repeat(1, 4)  # [B, 4*CW], slot c*CW + t
        dst = torch.where(live, ids.long(), rp)[..., None].expand(-1, -1, 3)
        pos.scatter_(1, dst, new)  # a sub-level's live lanes are distinct
    return tuple(pos[:, :rp, i].contiguous() for i in range(3))


# -- the substep on piece planes ------------------------------------------------


def _complete_boundary(arr: NHPiecesArrays, base, solved):
    """Cross-piece Jacobi completion, in place on the sweep's fresh outputs
    ``solved``: every shared particle's position becomes its predicted
    position ``base`` plus the mean of its per-piece deltas, (da + db) * 0.5
    for the J=2 band by one partner gather, the prefix-tier sum divided by
    the instance count for the rest."""
    has_tiers = bool(arr.tier_counts and arr.bnd_inst.shape[1])
    if not (has_tiers or arr.r2):
        return solved
    d3 = torch.stack([(s - b).reshape(-1) for s, b in zip(solved, base)],
                     dim=-1)  # [B*rp, 3]
    r2, rb = arr.r2, arr.rb
    if r2:
        back2 = d3[arr.pidx]  # [B, r2, 3]
        for i, (s, b) in enumerate(zip(solved, base)):
            m = (s[:, :r2] - b[:, :r2] + back2[..., i]) * 0.5
            s[:, :r2] = torch.where(arr.is2, b[:, :r2] + m, s[:, :r2])
    if has_tiers:
        tot = d3[arr.bnd_inst[0]]  # [Sb, 3]
        for j, c in enumerate(arr.tier_counts[1:], start=1):
            tot[:c] += d3[arr.bnd_inst[j, :c]]
        tot = tot / arr.bnd_count[:, None]
        lbm = arr.lane_bnd.reshape(arr.B, arr.rp)
        if r2 or rb < arr.rp:  # banded: the tier lanes are [r2:rb)
            lb = lbm[:, r2:rb]
            back = tot[lb.clamp(min=0)]  # [B, rb-r2, 3]
            for i, (s, b) in enumerate(zip(solved, base)):
                s[:, r2:rb] = torch.where(lb >= 0, b[:, r2:rb] + back[..., i],
                                          s[:, r2:rb])
        else:
            back = tot[lbm.clamp(min=0)]  # [B, rp, 3]
            for i, (s, b) in enumerate(zip(solved, base)):
                s.copy_(torch.where(lbm >= 0, b + back[..., i], s))
    return solved


def _substep_local(carry, arr: NHPiecesArrays, params: PhysicsParams, dt,
                   gid, gpos, solve):
    lx, ly, lz, vx, vy, vz = carry
    movable = arr.movw_l > 0.0
    plx, ply, plz = lx, ly, lz
    lx, ly, lz, vx, vy, vz = predict_planes(lx, ly, lz, vx, vy, vz, movable,
                                            dt, params)
    solved = solve(lx, ly, lz, arr, params)
    lx, ly, lz = _complete_boundary(arr, (lx, ly, lz), list(solved))
    lx, ly, lz = collide_planes(lx, ly, lz, plx, plz, dt, params)
    lx, ly, lz = grab_planes(arr.pid_l, lx, ly, lz, gid, gpos)
    return (lx, ly, lz, velocity_planes(lx, plx, dt),
            velocity_planes(ly, ply, dt), velocity_planes(lz, plz, dt))


def nh_pieces_frame_reference(packed, arr: NHPiecesArrays,
                              params: PhysicsParams, gid, gpos):
    """A frame in plain torch on the packed planes (lx, ly, lz, vx, vy, vz)
    [B, rp]: num_substeps substeps of predict, the sweep
    (``nh_pieces_solve_reference``), the completion across pieces
    (``_complete_boundary``), collide, grab and velocity."""
    for _ in range(params.num_substeps):
        packed = _substep_local(packed, arr, params, params.dt, gid, gpos,
                                nh_pieces_solve_reference)
    return packed


def nh_pieces_frame(packed, arr: NHPiecesArrays, params: PhysicsParams, gid,
                    gpos):
    """A frame on the packed planes (see ``nh_pieces_frame_reference``);
    gid int32 [G], gpos [G, 3].  CPU tensors take the plain path; any other
    device launches the CUDA kernel or raises."""
    with span(_SPAN):
        if packed[0].device.type == "cpu":
            return nh_pieces_frame_reference(packed, arr, params, gid, gpos)
        return _frame_cuda(packed, arr, params, gid, gpos)


def make_nh_pieces_stepper(arr: NHPiecesArrays, frame=nh_pieces_frame):
    """(pack, step, unpack, unpack_pos) over state in piece planes, as
    ``polar_pieces.make_pieces_stepper``; the packed state is (lx, ly, lz,
    vx, vy, vz) and ``unpack`` gives identity quaternions.  ``frame`` is the
    frame to run (``nh_pieces_frame_reference`` gives the plain twin on any
    device)."""

    def pack(state: SimState, params: PhysicsParams):
        del params
        return (tuple(to_local(state.pos[:, i], arr) for i in range(3))
                + tuple(to_local(state.vel[:, i], arr) for i in range(3)))

    def step(packed, params: PhysicsParams, controls: Controls):
        gid, gpos = common.norm_grabs(controls)
        return frame(packed, arr, params, gid, gpos)

    def unpack_pos(packed):
        return torch.stack([owned(packed[i], arr) for i in range(3)], dim=-1)

    def unpack(packed, params: PhysicsParams) -> SimState:
        pos = unpack_pos(packed)
        vel = torch.stack([owned(packed[3 + i], arr) for i in range(3)], dim=-1)
        quats = pos.new_zeros((arr.num_tets, 4))
        quats[:, 3].fill_(1.0)  # a fill, not a host-to-device copy
        return SimState(pos=pos, prev_pos=pos - vel * params.dt, vel=vel,
                        quats=quats)

    return pack, step, unpack, unpack_pos


def step_frame(state: SimState, arr: NHPiecesArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = num_substeps substeps (engine API; converts SimState to
    piece planes and back).  The kernel computes no volume error, so the
    per-substep diagnostic is NaN."""
    pack, step, unpack, _ = make_nh_pieces_stepper(arr)
    new = unpack(step(pack(state, params), params, controls), params)
    return new, state.pos.new_full((params.num_substeps,), float("nan"))


def substep(state: SimState, arr: NHPiecesArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One substep (engine API): a frame of params with num_substeps=1."""
    del dt
    one = dataclasses.replace(params, num_substeps=1)
    new, diags = step_frame(state, arr, one, controls)
    return new, diags[0]
