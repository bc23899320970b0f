"""Polar shape matching on one large unstructured mesh cut into pieces
(counterpart of ``tetsim_tpu/kernels/polar_pieces.py``): the
``polar_pieces`` engine, for a mesh too large and too irregular for the
fused frame kernel or the grid stencils (a TetGen import, an
``ellipsoid_mesh`` of a million tets).

The mesh is cut into balanced pieces by recursive coordinate bisection of
the tet centroids (``rcb_partition``).  Each piece's particles get local
lanes in reverse Cuthill-McKee order, optionally banded [J=2 | J>=3 |
interior] by how many pieces share them (``boundary_prefix``), and the
state lives in piece planes [B, rp] across substeps.  A substep is:
predict; the solve (corner gather, covariance, extract_rotation from the
identity, quaternion update, rest-volume-weighted goal deltas, and the
piece-local incidence sum into partial numerators); the cross-piece
completion of the shared particles' numerators (one partner gather for the
J=2 band, prefix tiers for the rest); apply with the global 1 / (sum of
incident rest volumes); collide; grab; velocity.  Every phase outside the
solve and the completion is elementwise, so the instances of a particle
stay bitwise equal.

``pieces_solve`` runs the solve: on CUDA tensors it launches the kernel of
``csrc/polar_pieces.cu`` (one block holds a piece's planes and deltas in
shared memory, so a piece must fit one: ``smem_bytes``, ``check_fits``), on
CPU tensors it runs ``pieces_solve_reference``, the same solve in plain
torch.  The rest of the
substep is torch ops on either device.  ``launch_count`` counts the kernel
launches.  The schedule helpers (``rcb_partition``, ``band_locals``,
``partner_tables``, ``completion_tables``) are shared with
``kernels/nh_pieces.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..mesh import TetMesh, rest_state
from ..params import PhysicsParams
from ..state import SimState, Controls
from ..solvers import common
from ..solvers.polar_grid import EXTRACT_ITERS, _extract_rotation, _qmul, _qrot_const
from ..spans import kernel, span
from . import build
from .batch import SMEM_LIMIT, expect

LAUNCHES_PER_SUBSTEP = 1  # as polar_pieces_launches_per_substep()
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # kernel launches since import (or reset)
_SPAN = kernel(__name__)  # the span of the module's kernel entry


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# -- host-side partition and schedule -----------------------------------------


@dataclasses.dataclass(frozen=True)
class PiecesSchedule:
    """Numpy tables of the polar pieces engine (B = piece count padded to a
    multiple of 8)."""

    ids: np.ndarray      # i32 [4, B, rt]  corner -> local particle lane
    inc: np.ndarray      # i32 [K, B, rp]  local incidence banks, -1 pad
    rc: np.ndarray       # f32 [12, B, rt] rest_centered rows k*3+r
    wvol: np.ndarray     # f32 [B, rt]     rest volume (0 on padded lanes)
    g2l: np.ndarray      # i32 [B, rp]     local lane -> global pid (N pad)
    tet_l2g: np.ndarray  # i32 [B, rt]     local tet lane -> global tet (M pad)
    tet_inst: np.ndarray  # i32 [M]        global tet -> piece*rt + lane
    owner_inst: np.ndarray  # i32 [N]      first instance (piece*rp + lane)
    bnd_inst: np.ndarray  # i32 [Jmax, Sb] j-th instance of boundary row i
    tier_counts: tuple    # [Jmax] prefix counts (rows sorted by J descending)
    lane_bnd: np.ndarray  # i32 [B*rp]     compact boundary row or -1
    pidx: np.ndarray      # i32 [B, r2]    J=2 partner flat lane (self pad)
    is2: np.ndarray       # bool [B, r2]   lane holds a J=2 particle
    invden: np.ndarray    # f32 [N]
    movw: np.ndarray      # f32 [N]
    inv_mass: np.ndarray  # f32 [N]
    num_particles: int
    num_tets: int
    n_pieces: int
    B: int
    rp: int
    rt: int
    rb: int  # end of the shared-lane bands (rp without boundary_prefix)
    r2: int  # end of the J=2 band (0 without boundary_prefix)
    valence: int


def _rcm_particle_order(tets: np.ndarray, n: int) -> np.ndarray:
    """Bandwidth-minimising particle order (reverse Cuthill-McKee) over the
    tet-sharing graph: it bounds the local particle span of a piece."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    pairs = [tets[:, (a, b)] for a in range(4) for b in range(a + 1, 4)]
    e = np.concatenate(pairs, axis=0)
    g = sp.coo_matrix(
        (np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(n, n)
    ).tocsr()
    g = g + g.T
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True))


def rcb_partition(mesh: TetMesh, tets_per_piece: int):
    """Compact tet pieces by recursive coordinate bisection of the tet
    centroids, a power-of-two piece count with every piece within one tet
    of the same size.  Returns (list of tet-id arrays, piece count)."""
    m = mesh.num_tets
    centroids = mesh.verts[mesh.tets].mean(axis=1)
    n_pieces = 1
    while n_pieces * tets_per_piece < m:
        n_pieces *= 2
    parts = [np.arange(m)]
    while len(parts) < n_pieces:
        nxt = []
        for big in parts:
            c = centroids[big]
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            med = np.argsort(c[:, ax], kind="stable")
            h = len(big) // 2
            nxt += [big[med[:h]], big[med[h:]]]
        parts = nxt
    return parts, n_pieces


def band_locals(locals_list, n: int):
    """The [J2 | J>=3 | interior] lane banding: particles shared by exactly
    2 pieces land in [0:r2), by 3 or more in [r2:rb), the rest in [rb:rp),
    hole lanes between bands unmapped; band widths are the largest over the
    pieces, rounded up to 128.  Returns (banded locals list, lane-position
    list, r2, rb, rp)."""
    icount = np.zeros(n, np.int64)
    for locals_ in locals_list:
        icount[locals_] += 1
    n2_max = n3_max = ni_max = 0
    banded = []
    for locals_ in locals_list:
        c = icount[locals_]
        b2, b3, bi = locals_[c == 2], locals_[c > 2], locals_[c == 1]
        banded.append((b2, b3, bi))
        n2_max = max(n2_max, len(b2))
        n3_max = max(n3_max, len(b3))
        ni_max = max(ni_max, len(bi))
    r2 = _round_up(n2_max, 128) if n2_max else 0
    r3 = _round_up(n3_max, 128) if n3_max else 0
    rb = r2 + r3
    rp = rb + (_round_up(ni_max, 128) if ni_max else 0)
    out_locals, out_lanepos = [], []
    for b2, b3, bi in banded:
        out_locals.append(np.concatenate([b2, b3, bi]))
        out_lanepos.append(np.concatenate([
            np.arange(len(b2)), r2 + np.arange(len(b3)), rb + np.arange(len(bi)),
        ]))
    return out_locals, out_lanepos, r2, rb, rp


def partner_tables(instances, n: int, b_pad: int, rp: int, r2: int):
    """J=2 partner tables over the [0:r2) band: pidx [B, r2] holds each J=2
    lane's twin as a flat lane index (itself for other lanes), is2 [B, r2]
    marks the pairs.  One gather completes every J=2 particle, and f32
    a + b is commutative, so both replicas stay bitwise equal."""
    pidx = np.zeros((b_pad, r2), np.int32)
    is2 = np.zeros((b_pad, r2), bool)
    if r2:
        pidx[:] = np.arange(b_pad)[:, None] * rp + np.arange(r2)[None, :]
        for p in range(n):
            inst = instances[p]
            if len(inst) == 2:
                a, b = inst
                pidx[a // rp, a % rp] = b
                pidx[b // rp, b % rp] = a
                is2[a // rp, a % rp] = True
                is2[b // rp, b % rp] = True
    return pidx, is2


def completion_tables(instances, n: int, lanes_total: int,
                      exclude_pairs: bool = False):
    """Completion tables over the compact boundary space: the particles with
    more than one instance (at least 3 with ``exclude_pairs``) sorted by
    instance count, descending, so that tier j gathers only the prefix
    [0:C_j) of rows that have a j-th instance.  Returns (owner_inst [n],
    bnd_inst [Jmax, Sb], tier_counts, lane_bnd [lanes_total])."""
    owner_inst = np.zeros(n, np.int32)
    for p in range(n):
        owner_inst[p] = instances[p][0]
    min_j = 3 if exclude_pairs else 2
    bnd = [p for p in range(n) if len(instances[p]) >= min_j]
    bnd.sort(key=lambda p: -len(instances[p]))
    sb = len(bnd)
    jmax = max((len(instances[p]) for p in bnd), default=0)
    bnd_inst = np.zeros((max(jmax, 1), max(sb, 1)), np.int32)
    tier_counts = []
    for j in range(jmax):
        c = sum(1 for p in bnd if len(instances[p]) > j)
        tier_counts.append(c)
        for i in range(c):
            bnd_inst[j, i] = instances[bnd[i]][j]
    lane_bnd = np.full(lanes_total, -1, np.int32)
    for i, p in enumerate(bnd):
        for inst in instances[p]:
            lane_bnd[inst] = i
    return owner_inst, bnd_inst, tuple(tier_counts), lane_bnd


def build_pieces_schedule(mesh: TetMesh, density: float = 1000.0,
                          tets_per_piece: int = 2048, pinned=None,
                          boundary_prefix: bool = False) -> PiecesSchedule:
    _, _, vol, im, rc = rest_state(mesh, density, pinned=pinned)
    tets = mesh.tets
    n, m = mesh.num_particles, mesh.num_tets

    order = _rcm_particle_order(tets, n)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    # RCM is the local particle order; the pieces come from RCB
    parts, n_pieces = rcb_partition(mesh, tets_per_piece)
    b_pad = _round_up(n_pieces, 8)

    pieces = []  # (tet ids, local particles sorted by rank)
    rp = rt = kmax = 0
    for te in parts:
        locals_ = np.unique(tets[te].reshape(-1))
        locals_ = locals_[np.argsort(rank[locals_], kind="stable")]
        pieces.append((te, locals_))
        rt = max(rt, len(te))
        rp = max(rp, len(locals_))
        counts = np.bincount(tets[te].reshape(-1), minlength=n)
        kmax = max(kmax, int(counts.max()))
    rp, rt = _round_up(rp, 128), _round_up(rt, 128)

    # boundary_prefix: lanes [0:r2) hold particles shared by exactly 2
    # pieces, [r2:rb) by 3 or more, [rb:rp) the interior
    rb, r2 = rp, 0
    if boundary_prefix:
        loc, pos, r2, rb, rp = band_locals([locals_ for _, locals_ in pieces], n)
        pieces = [(te, loc[i], pos[i]) for i, (te, _) in enumerate(pieces)]
    else:
        pieces = [(te, locals_, np.arange(len(locals_)))
                  for te, locals_ in pieces]

    ids = np.zeros((4, b_pad, rt), np.int32)
    inc = np.full((kmax, b_pad, rp), -1, np.int32)
    rc12 = np.zeros((12, b_pad, rt), np.float32)
    wvol = np.zeros((b_pad, rt), np.float32)
    g2l = np.full((b_pad, rp), n, np.int32)
    tet_l2g = np.full((b_pad, rt), m, np.int32)
    tet_inst = np.zeros(m, np.int32)
    instances = [[] for _ in range(n)]  # global pid -> flat instances

    lut = np.empty(n, np.int64)
    for p, (te, locals_, lanepos) in enumerate(pieces):
        lut[locals_] = lanepos
        lt_local = lut[tets[te]]
        # piece tets sorted by their first local corner
        perm = np.argsort(lt_local[:, 0], kind="stable")
        te_s = te[perm]
        lt_local = lt_local[perm]
        mt = len(te_s)
        ids[:, p, :mt] = lt_local.T
        wvol[p, :mt] = vol[te_s]
        rcp = rc[te_s]
        for k in range(4):
            for r in range(3):
                rc12[k * 3 + r, p, :mt] = rcp[:, k, r]
        g2l[p, lanepos] = locals_
        tet_l2g[p, :mt] = te_s
        tet_inst[te_s] = p * rt + np.arange(mt)
        # incidence banks: a lane's corner slots k*rt + t in ascending
        # corner-instance order, in banks 0, 1, ... (a prefix of the K banks)
        seg = lt_local.reshape(-1)  # corner instance t*4 + k -> lane
        inst_order = np.argsort(seg, kind="stable")
        counts = np.bincount(seg, minlength=rp)
        starts = np.cumsum(counts) - counts
        bank = np.arange(4 * mt, dtype=np.int64) - np.repeat(starts, counts)
        tt, kk = inst_order // 4, inst_order % 4
        inc[bank, p, seg[inst_order]] = (kk * rt + tt).astype(np.int32)
        for i, g in zip(lanepos, locals_):
            instances[int(g)].append(p * rp + int(i))

    # every lane of a shared particle reads its completed total back from
    # its compact boundary row; under boundary_prefix the J=2 particles are
    # completed by the partner tables instead
    owner_inst, bnd_inst, tier_counts, lane_bnd = completion_tables(
        instances, n, b_pad * rp, exclude_pairs=bool(r2))
    pidx, is2 = partner_tables(instances, n, b_pad, rp, r2)

    # the polar engine's global scatter denominator and movable mask
    den = np.zeros(n, np.float64)
    np.add.at(den, tets.reshape(-1), np.repeat(vol.astype(np.float64), 4))
    invden = (1.0 / np.maximum(den.astype(np.float32), 1e-9)).astype(np.float32)
    movw = (im > 0.0).astype(np.float32)

    return PiecesSchedule(
        ids=ids, inc=inc, rc=rc12, wvol=wvol, g2l=g2l, tet_l2g=tet_l2g,
        tet_inst=tet_inst, owner_inst=owner_inst, bnd_inst=bnd_inst,
        tier_counts=tier_counts, lane_bnd=lane_bnd, pidx=pidx, is2=is2,
        invden=invden, movw=movw, inv_mass=np.asarray(im, np.float32),
        num_particles=n, num_tets=m, n_pieces=n_pieces, B=b_pad, rp=rp,
        rt=rt, rb=rb, r2=r2, valence=kmax,
    )


# -- device tables -------------------------------------------------------------


def to_device(arrays, device):
    """A pieces arrays dataclass with every tensor field moved to
    ``device``."""
    return dataclasses.replace(arrays, **{
        f.name: getattr(arrays, f.name).to(device)
        for f in dataclasses.fields(arrays)
        if isinstance(getattr(arrays, f.name), torch.Tensor)})


@dataclasses.dataclass
class PiecesArrays:
    """The polar pieces engine's tables as tensors on one device, and their
    static shape."""

    num_particles: int
    num_tets: int
    B: int
    rp: int
    rt: int
    rb: int
    r2: int
    valence: int
    tier_counts: tuple
    # the solve's tables
    ids: torch.Tensor  # i32 [4, B, rt]
    inc: torch.Tensor  # i32 [K, B, rp]
    rc: torch.Tensor  # f32 [12, B, rt]
    wvol: torch.Tensor  # f32 [B, rt]
    # completion and conversion maps
    g2l_flat: torch.Tensor  # i32 [B*rp]
    tet_l2g_flat: torch.Tensor  # i32 [B*rt]
    tet_inst: torch.Tensor  # i32 [M]
    owner_inst: torch.Tensor  # i32 [N]
    bnd_inst: torch.Tensor  # i32 [Jmax, Sb]
    lane_bnd: torch.Tensor  # i32 [B*rp] (-1 interior)
    pidx: torch.Tensor  # i32 [B, r2]
    is2: torch.Tensor  # bool [B, r2]
    # per-lane constant planes
    invden_l: torch.Tensor  # f32 [B, rp]
    movw_l: torch.Tensor  # f32 [B, rp]
    pid_l: torch.Tensor  # i32 [B, rp] global pid (N on padding)
    inv_mass: torch.Tensor  # f32 [N] (diagnostics)

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def to(self, device) -> "PiecesArrays":
        return to_device(self, device)


def build_pieces_arrays(mesh: TetMesh, density: float = 1000.0,
                        tets_per_piece: int = 2048, pinned=None,
                        boundary_prefix: bool = False, *,
                        device) -> PiecesArrays:
    s = build_pieces_schedule(mesh, density, tets_per_piece, pinned,
                              boundary_prefix)
    invden_pad = np.concatenate([s.invden, np.zeros(1, np.float32)])
    movw_pad = np.concatenate([s.movw, np.zeros(1, np.float32)])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return PiecesArrays(
        num_particles=s.num_particles, num_tets=s.num_tets, B=s.B, rp=s.rp,
        rt=s.rt, rb=s.rb, r2=s.r2, valence=s.valence,
        tier_counts=s.tier_counts, ids=t(s.ids), inc=t(s.inc), rc=t(s.rc),
        wvol=t(s.wvol), g2l_flat=t(s.g2l.reshape(-1)),
        tet_l2g_flat=t(s.tet_l2g.reshape(-1)), tet_inst=t(s.tet_inst),
        owner_inst=t(s.owner_inst), bnd_inst=t(s.bnd_inst),
        lane_bnd=t(s.lane_bnd), pidx=t(s.pidx), is2=t(s.is2),
        invden_l=t(invden_pad[s.g2l]), movw_l=t(movw_pad[s.g2l]),
        pid_l=t(s.g2l), inv_mass=t(s.inv_mass),
    )


# -- the solve: kernel and plain twin -------------------------------------------


def frame_flops(arr: PiecesArrays, params: PhysicsParams) -> int:
    """Floating-point operations of the solve in one frame, counted as
    ``polar_fused.frame_flops`` counts the same per-tet arithmetic: per tet
    and substep 391 plus 136 per extract_rotation iteration, and 3 adds per
    incident corner (12 per tet).  Padded tet lanes carry no work and are
    not counted; the torch phases around the solve are not counted."""
    per_tet = 391 + 136 * params.extract_iters + 12
    return params.num_substeps * arr.num_tets * per_tet


def frame_bytes(arr: PiecesArrays, params: PhysicsParams) -> int:
    """Bytes the solve must move in one frame: each substep reads the three
    position planes and writes the three numerator planes, and per tet
    reads its quaternion, 4 corner lanes, 12 rest coordinates, its rest
    volume and its 4 incidence entries and writes its quaternion (116
    bytes); padded lanes and the -1 incidence padding carry no work."""
    planes = 6 * 4 * arr.B * arr.rp
    return params.num_substeps * (planes + 116 * arr.num_tets)


def smem_bytes(rp: int, rt: int) -> int:
    """Shared memory of one block: a piece's three position planes and its
    weighted goal deltas [3, 4 rt] (109.5 KB at rp 1,152 and rt 2,048, so
    two blocks fit an SM)."""
    return 4 * (3 * rp + 12 * rt)


def check_fits(arr: PiecesArrays) -> None:
    """Raise ValueError unless one piece of ``arr`` fits a block's shared
    memory on Hopper (``SMEM_LIMIT``), naming the largest tets_per_piece
    that would, at this mesh's ratio of particle lanes to tet lanes."""
    need = smem_bytes(arr.rp, arr.rt)
    if need > SMEM_LIMIT:
        per_tet = 48 + 12 * arr.rp / arr.rt
        largest = int(SMEM_LIMIT // per_tet) // 128 * 128
        raise ValueError(
            f"the polar pieces kernel keeps a piece in shared memory: rp="
            f"{arr.rp} particle and rt={arr.rt} tet lanes need {need} bytes, "
            f"a Hopper block has SMEM_LIMIT = {SMEM_LIMIT}; build with "
            f"tets_per_piece of at most about {largest}")


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments
    declared."""
    lib = build.load("polar_pieces", NVCC_FLAGS)
    if lib.polar_pieces_launch.argtypes is None:
        lib.polar_pieces_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.polar_pieces_launch.restype = ctypes.c_int
        lib.polar_pieces_error_string.argtypes = [ctypes.c_int]
        lib.polar_pieces_error_string.restype = ctypes.c_char_p
        lib.polar_pieces_launches_per_substep.restype = ctypes.c_int
        lib.polar_pieces_threads.restype = ctypes.c_int
        lib.polar_pieces_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.polar_pieces_smem_bytes.restype = ctypes.c_size_t
        if lib.polar_pieces_launches_per_substep() != LAUNCHES_PER_SUBSTEP:
            raise RuntimeError("csrc/polar_pieces.cu launches per substep != "
                               "polar_pieces.LAUNCHES_PER_SUBSTEP")
        if lib.polar_pieces_smem_bytes(1152, 2048) != smem_bytes(1152, 2048):
            raise RuntimeError("csrc/polar_pieces.cu smem_bytes != "
                               "polar_pieces.smem_bytes")
    return lib


def _pieces_solve_cuda(px, py, pz, quats, arr: PiecesArrays, iters: int):
    global launch_count
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"the polar pieces kernels run on CUDA, not {dev}")
    check_fits(arr)
    B, rp, rt, K = arr.B, arr.rp, arr.rt, arr.valence
    f32, i32 = torch.float32, torch.int32
    for name, plane in (("px", px), ("py", py), ("pz", pz)):
        expect(plane, name, f32, (B, rp), dev)
    expect(quats, "quats", f32, (4, B, rt), dev)
    expect(arr.ids, "ids", i32, (4, B, rt), dev)
    expect(arr.inc, "inc", i32, (K, B, rp), dev)
    expect(arr.rc, "rc", f32, (12, B, rt), dev)
    expect(arr.wvol, "wvol", f32, (B, rt), dev)

    lib = library()
    num = torch.empty((3, B, rp), dtype=f32, device=dev)
    quat_out = torch.empty_like(quats)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.polar_pieces_launch(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), quats.data_ptr(),
            quat_out.data_ptr(), num.data_ptr(),
            arr.ids.data_ptr(), arr.inc.data_ptr(), arr.rc.data_ptr(),
            arr.wvol.data_ptr(), B, rp, rt, K, iters,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("polar_pieces launch failed: "
                           f"{lib.polar_pieces_error_string(err).decode()}")
    launch_count += LAUNCHES_PER_SUBSTEP
    return num[0], num[1], num[2], quat_out


def tet_pass_reference(px, py, pz, quats, arr: PiecesArrays,
                       iters: int = EXTRACT_ITERS):
    """The solve's tet pass in plain torch (see ``pieces_solve_reference``):
    returns (the weighted goal deltas, three planes [B, 4 rt] at slot
    k*rt + t, and the updated quaternions [4, B, rt])."""
    ids = arr.ids.long()
    corners = [[torch.gather(plane, 1, ids[k]) for k in range(4)]
               for plane in (px, py, pz)]
    pc = []
    for c in corners:
        cc = (((c[0] + c[1]) + c[2]) + c[3]) * 0.25
        pc.append([x - cc for x in c])
    qx, qy, qz, qw = quats.unbind(0)
    rest = [(arr.rc[3 * k], arr.rc[3 * k + 1], arr.rc[3 * k + 2])
            for k in range(4)]
    rr = [_qrot_const(v, qx, qy, qz, qw) for v in rest]
    a = [[sum(pc[r][k] * rr[k][c] for k in range(4)) for c in range(3)]
         for r in range(3)]
    ix, iy, iz, iw = _extract_rotation(a, iters)
    qx, qy, qz, qw = _qmul(ix, iy, iz, iw, qx, qy, qz, qw)
    norm = torch.sqrt(qx * qx + qy * qy + qz * qz + qw * qw).clamp(min=1e-30)
    qx, qy, qz, qw = qx / norm, qy / norm, qz / norm, qw / norm

    # corner-major delta planes [B, 4*rt], slot k*rt + t
    goals = [_qrot_const(v, qx, qy, qz, qw) for v in rest]
    deltas = [torch.cat([(goals[k][r] - pc[r][k]) * arr.wvol for k in range(4)],
                        dim=1) for r in range(3)]
    return deltas, torch.stack([qx, qy, qz, qw])


def pieces_solve_reference(px, py, pz, quats, arr: PiecesArrays,
                           iters: int = EXTRACT_ITERS):
    """The solve in plain torch: positions px/py/pz [B, rp], quaternions
    [4, B, rt].  Returns (numx, numy, numz [B, rp], quats [4, B, rt]): the
    piece-local partial numerators and the updated quaternions."""
    deltas, quats = tet_pass_reference(px, py, pz, quats, arr, iters)
    num = [torch.zeros_like(px) for _ in range(3)]
    for bank in arr.inc.unbind(0):
        live = bank >= 0
        idx = bank.clamp(min=0).long()
        for r in range(3):
            num[r] = num[r] + torch.where(live, torch.gather(deltas[r], 1, idx),
                                          0.0)
    return num[0], num[1], num[2], quats


def pieces_solve(px, py, pz, quats, arr: PiecesArrays,
                 iters: int = EXTRACT_ITERS):
    """The solve (see ``pieces_solve_reference`` for shapes).  CPU tensors
    take the plain path; any other device launches the CUDA kernel or
    raises (``check_fits``: also where a piece is over a block's shared
    memory)."""
    with span(_SPAN):
        if px.device.type == "cpu":
            return pieces_solve_reference(px, py, pz, quats, arr, iters)
        return _pieces_solve_cuda(px, py, pz, quats, arr, iters)


# -- the substep on piece planes ------------------------------------------------


def predict_planes(lx, ly, lz, vx, vy, vz, movable, dt, params: PhysicsParams):
    """``common.predict`` on piece planes: returns (lx, ly, lz, vx, vy, vz)."""
    vy = vy + params.gravity * dt
    vx = torch.where(movable, vx, 0.0)
    vy = torch.where(movable, vy, 0.0)
    vz = torch.where(movable, vz, 0.0)
    return lx + vx * dt, ly + vy * dt, lz + vz * dt, vx, vy, vz


def collide_planes(lx, ly, lz, plx, plz, dt, params: PhysicsParams):
    """``common.collide`` on piece planes (elementwise, so duplicated lanes
    stay equal)."""
    lo, hi = params.world_min, params.world_max
    lx = lx.clamp(float(lo[0]), float(hi[0]))
    ly = ly.clamp(float(lo[1]), float(hi[1]))
    lz = lz.clamp(float(lo[2]), float(hi[2]))
    below = ly < 0.0
    ly = torch.where(below, 0.0, ly)
    k = np.minimum(np.float32(1.0), dt * params.friction)
    lx = lx + torch.where(below, (plx - lx) * k, 0.0)
    lz = lz + torch.where(below, (plz - lz) * k, 0.0)
    return lx, ly, lz


def grab_planes(pid_l, lx, ly, lz, gid, gpos):
    """Grab overrides by global particle id: every lane of a grabbed particle
    takes the target (the last grab on it wins)."""
    for g in range(gid.shape[0]):
        hit = pid_l == gid[g]
        lx = torch.where(hit, gpos[g, 0], lx)
        ly = torch.where(hit, gpos[g, 1], ly)
        lz = torch.where(hit, gpos[g, 2], lz)
    return lx, ly, lz


def velocity_planes(l, pl, dt):
    """(l - prev) / dt as a true division (``common.velocity_update``)."""
    return (l - pl) / l.new_full((), dt)


def _complete_numerators(arr: PiecesArrays, num):
    """Cross-piece sum of the shared particles' partial numerators, in
    place on the solve's fresh outputs ``num`` (a list of three planes): one
    partner gather over the J=2 band, then the prefix tiers in order (row
    total = instance 0, then + instance 1, 2, ...), read back by every
    instance."""
    has_tiers = bool(arr.bnd_inst.shape[1] and arr.tier_counts)
    if not (has_tiers or arr.r2):
        return num
    num3 = torch.stack([n.reshape(-1) for n in num], dim=-1)  # [B*rp, 3]
    r2, rb = arr.r2, arr.rb
    if r2:
        back2 = num3[arr.pidx]  # [B, r2, 3]
        for i, n in enumerate(num):
            n[:, :r2] = torch.where(arr.is2, n[:, :r2] + back2[..., i], n[:, :r2])
    if has_tiers:
        tot = num3[arr.bnd_inst[0]]  # [Sb, 3]
        for j, c in enumerate(arr.tier_counts[1:], start=1):
            tot[:c] += num3[arr.bnd_inst[j, :c]]
        lbm = arr.lane_bnd.reshape(arr.B, arr.rp)
        if r2 or rb < arr.rp:  # banded: the tier lanes are [r2:rb)
            lb = lbm[:, r2:rb]
            back = tot[lb.clamp(min=0)]  # [B, rb-r2, 3]
            for i, n in enumerate(num):
                n[:, r2:rb] = torch.where(lb >= 0, back[..., i], n[:, r2:rb])
        else:
            back = tot[lbm.clamp(min=0)]  # [B, rp, 3]
            for i, n in enumerate(num):
                n.copy_(torch.where(lbm >= 0, back[..., i], n))
    return num


def _substep_local(carry, arr: PiecesArrays, params: PhysicsParams, dt,
                   gid, gpos, solve):
    lx, ly, lz, vx, vy, vz, q = carry
    movable = arr.movw_l > 0.0
    plx, ply, plz = lx, ly, lz
    lx, ly, lz, vx, vy, vz = predict_planes(lx, ly, lz, vx, vy, vz, movable,
                                            dt, params)
    *num, q = solve(lx, ly, lz, q, arr, params.extract_iters)
    numx, numy, numz = _complete_numerators(arr, list(num))
    lx = torch.where(movable, lx + numx * arr.invden_l, lx)
    ly = torch.where(movable, ly + numy * arr.invden_l, ly)
    lz = torch.where(movable, lz + numz * arr.invden_l, lz)
    lx, ly, lz = collide_planes(lx, ly, lz, plx, plz, dt, params)
    lx, ly, lz = grab_planes(arr.pid_l, lx, ly, lz, gid, gpos)
    return (lx, ly, lz, velocity_planes(lx, plx, dt),
            velocity_planes(ly, ply, dt), velocity_planes(lz, plz, dt), q)


def to_local(comp, arr):
    """A global per-particle component [N] as piece planes [B, rp] (0 on
    padded lanes)."""
    padded = torch.cat([comp, comp.new_zeros(1)])
    return padded[arr.g2l_flat].reshape(arr.B, arr.rp)


def owned(plane, arr):
    """Piece planes [B, rp] as a global component [N], read at each
    particle's first instance."""
    return plane.reshape(-1)[arr.owner_inst]


def _quats_to_pieces(quats, arr: PiecesArrays):
    qpad = torch.cat([quats, quats.new_zeros((1, 4))])
    qpad[-1:, 3].fill_(1.0)  # padded tet lanes hold the identity (no copy)
    q = qpad[arr.tet_l2g_flat].reshape(arr.B, arr.rt, 4)
    return q.permute(2, 0, 1).contiguous()  # [4, B, rt]


def _quats_from_pieces(q, arr: PiecesArrays):
    return q.permute(1, 2, 0).reshape(arr.B * arr.rt, 4)[arr.tet_inst]


def make_pieces_stepper(arr: PiecesArrays, solve=pieces_solve):
    """(pack, step, unpack, unpack_pos) over state in piece planes, the
    sustained form: SimState is built only at the I/O boundary.  ``solve``
    is the solve to run (``pieces_solve_reference`` gives the plain twin of
    the whole substep on any device).

    pack(state, params)            -> packed (lx, ly, lz, vx, vy, vz, quats)
    step(packed, params, controls) -> packed   (num_substeps substeps)
    unpack(packed, params)         -> SimState
    unpack_pos(packed)             -> positions [N, 3]"""

    def pack(state: SimState, params: PhysicsParams):
        del params
        return (tuple(to_local(state.pos[:, i], arr) for i in range(3))
                + tuple(to_local(state.vel[:, i], arr) for i in range(3))
                + (_quats_to_pieces(state.quats, arr),))

    def step(packed, params: PhysicsParams, controls: Controls):
        gid, gpos = common.norm_grabs(controls)
        for _ in range(params.num_substeps):
            packed = _substep_local(packed, arr, params, params.dt, gid, gpos,
                                    solve)
        return packed

    def unpack_pos(packed):
        return torch.stack([owned(packed[i], arr) for i in range(3)], dim=-1)

    def unpack(packed, params: PhysicsParams) -> SimState:
        pos = unpack_pos(packed)
        vel = torch.stack([owned(packed[3 + i], arr) for i in range(3)], dim=-1)
        return SimState(pos=pos, prev_pos=pos - vel * params.dt, vel=vel,
                        quats=_quats_from_pieces(packed[6], arr))

    return pack, step, unpack, unpack_pos


def step_frame(state: SimState, arr: PiecesArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = num_substeps substeps (engine API; converts SimState to
    piece planes and back).  The solve computes no volume error, so the
    per-substep diagnostic is NaN."""
    pack, step, unpack, _ = make_pieces_stepper(arr)
    new = unpack(step(pack(state, params), params, controls), params)
    return new, state.pos.new_full((params.num_substeps,), float("nan"))


def substep(state: SimState, arr: PiecesArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One substep (engine API): a frame of params with num_substeps=1."""
    del dt
    one = dataclasses.replace(params, num_substeps=1)
    new, diags = step_frame(state, arr, one, controls)
    return new, diags[0]
