"""Structured-grid polar engine (counterpart of
``tetsim_tpu/solvers/polar_grid.py``): Müller shape matching with Jacobi
iteration on ``grid_mesh`` boxes, the scale path for box meshes.

Every tet corner of a ``grid_mesh(nx, ny, nz)`` box sits at one of the 8
cube-corner offsets, so the corner gather becomes 8 shifted reads of the
flat C-order vertex grid (``v = (i*gy + j)*gz + k``) and the particle
scatter 8 shifted slice-adds of per-slab accumulators (the inverse
stencil).  The state is flat component arrays with one phantom x-plane of
tail padding, cube lanes span ``[nx, gy, gz]`` (phantom lanes at
``j == ny`` or ``k == nz`` are masked), and quaternions are ``[6][4]``
component arrays over cube lanes, as in the JAX engine.  Every sum is
written out in the JAX engine's order; a leading body axis is allowed on
every state array.

``step_frame`` hands the frame to ``kernels/polar_stencil.grid_frame``: on
a CPU tensor that runs this plain-torch path, on a CUDA tensor it launches
the stencil kernel (``kernels/csrc/polar_stencil.cu``) twice per substep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..mesh import TetMesh
from ..params import PhysicsParams
from ..state import SimState, Controls
from . import common

EXTRACT_ITERS = 9  # PhysicsParams.extract_iters' default
EPS = 1e-9
SLAB_OFFSETS = tuple(
    (dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
)


@dataclasses.dataclass
class GridArrays:
    """Stencil-form constants of a ``grid_mesh`` box: the corner offsets and
    rest shapes (uniform per Kuhn type, host values) and the per-particle
    fields on the device, shaped as the vertex grid [gx, gy, gz]."""

    dims: Tuple[int, int, int]  # cubes
    corner_slab: Tuple  # [6][4]: slab index of each type's corners
    slab_offsets: Tuple  # [8] (dx, dy, dz)
    rest_centered: Tuple  # [6][4][3] floats
    rest_volume: float  # uniform rest volume (f32 value)
    inv_mass: torch.Tensor  # f32 [gx, gy, gz]
    den: torch.Tensor  # f32 [gx, gy, gz]: sum of incident rest volumes

    @property
    def num_particles(self) -> int:
        nx, ny, nz = self.dims
        return (nx + 1) * (ny + 1) * (nz + 1)

    @property
    def num_tets(self) -> int:
        nx, ny, nz = self.dims
        return 6 * nx * ny * nz

    @property
    def device(self) -> torch.device:
        return self.inv_mass.device

    def to(self, device) -> "GridArrays":
        return dataclasses.replace(self, inv_mass=self.inv_mass.to(device),
                                   den=self.den.to(device))


def decode_cube_corners(mesh: TetMesh, dims):
    """Cube (0, 0, 0) of each Kuhn type, read from the mesh itself so the
    corner order follows ``grid_mesh``'s positive-orientation swap.
    Returns (corner_slab [6][4], corners [6] of f32 [4,3], rest volume as a
    Python float); raises unless the mesh is a ``grid_mesh(*dims)`` with
    tets of one volume."""
    nx, ny, nz = dims
    gx, gy, gz = nx + 1, ny + 1, nz + 1
    ncubes = nx * ny * nz
    if mesh.num_tets != 6 * ncubes or mesh.num_particles != gx * gy * gz:
        raise ValueError(
            f"mesh ({mesh.num_tets} tets / {mesh.num_particles} particles) "
            f"is not a grid_mesh({nx},{ny},{nz}) "
            f"(expected {6 * ncubes} / {gx * gy * gz})"
        )
    slab_index = {off: s for s, off in enumerate(SLAB_OFFSETS)}
    corner_slab, corners, vol0 = [], [], None
    for t in range(6):
        row = mesh.tets[t * ncubes]
        offs = [(int(v) // (gy * gz), (int(v) // gz) % gy, int(v) % gz)
                for v in row]
        if any(o not in slab_index for o in offs):
            raise ValueError("mesh tets do not follow grid_mesh cube layout")
        corner_slab.append(tuple(slab_index[o] for o in offs))
        p = mesh.verts[row].astype(np.float32)
        d = np.stack([p[1] - p[0], p[2] - p[0], p[3] - p[0]], axis=-1)
        v = float(np.linalg.det(d.astype(np.float64)) / 6.0)
        if vol0 is None:
            vol0 = v
        elif not math.isclose(v, vol0, rel_tol=1e-5):
            raise ValueError("grid_mesh tets are not uniform volume")
        corners.append(p)
    return tuple(corner_slab), corners, vol0


def incidence_count(dims, corner_slab) -> np.ndarray:
    """int64 [gx, gy, gz]: the tet corners that land on each vertex."""
    nx, ny, nz = dims
    count = np.zeros((nx + 1, ny + 1, nz + 1), np.int64)
    for t in range(6):
        for k in range(4):
            dx, dy, dz = SLAB_OFFSETS[corner_slab[t][k]]
            count[dx:dx + nx, dy:dy + ny, dz:dz + nz] += 1
    return count


def lumped_inv_mass(count, vol0: float, density, pinned) -> np.ndarray:
    """Inverse lumped mass (every tet adds V/4 * density to its corners),
    0 on pinned particles; f32 shaped as ``count``."""
    pm = np.float32(vol0 / 4.0 * float(density))
    mass = count.astype(np.float32) * pm
    inv_mass = np.where(mass > 0.0, np.float32(1.0) / mass,
                        np.float32(0.0)).astype(np.float32)
    if pinned is not None:
        flat = inv_mass.reshape(-1)
        flat[np.asarray(pinned, np.int64)] = 0.0
    return inv_mass


def build_grid_arrays(mesh: TetMesh, dims, density: float = 1000.0,
                      pinned=None, *, device) -> GridArrays:
    """The stencil description of a ``grid_mesh(*dims)`` mesh, decoded from
    the mesh's own arrays, with the per-particle fields on ``device``."""
    dims = tuple(int(d) for d in dims)
    corner_slab, corners, vol0 = decode_cube_corners(mesh, dims)
    rest_centered = []
    for p in corners:
        centroid = (((p[0] + p[1]) + p[2]) + p[3]) * np.float32(0.25)
        rest_centered.append(tuple(tuple(float(x) for x in c)
                                   for c in p - centroid))
    w32 = float(np.float32(vol0))  # rest_state's f64 det -> f32 volume
    count = incidence_count(dims, corner_slab)
    # scatter denominator: f64 sum of the f32 rest volume, then f32
    den = (count * np.float64(w32)).astype(np.float32)
    inv_mass = lumped_inv_mass(count, vol0, density, pinned)
    return GridArrays(
        dims=dims, corner_slab=corner_slab, slab_offsets=SLAB_OFFSETS,
        rest_centered=tuple(rest_centered), rest_volume=w32,
        inv_mass=torch.as_tensor(inv_mass).to(device),
        den=torch.as_tensor(den).to(device),
    )


# -- component-wise quaternion math ([..., C] tensors) ------------------------


def _qrot_const(v, qx, qy, qz, qw):
    """Rotate the constant 3-vector v by quaternions q: v + 2 u x (u x v +
    w v)."""
    vx, vy, vz = v
    tx = qy * vz - qz * vy + qw * vx
    ty = qz * vx - qx * vz + qw * vy
    tz = qx * vy - qy * vx + qw * vz
    rx = qy * tz - qz * ty
    ry = qz * tx - qx * tz
    rz = qx * ty - qy * tx
    return vx + 2.0 * rx, vy + 2.0 * ry, vz + 2.0 * rz


def _qmul(ax, ay, az, aw, bx, by, bz, bw):
    """Hamilton product a b, xyzw."""
    return (
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    )


def _extract_rotation(a, iters: int = EXTRACT_ITERS):
    """Müller's robust polar decomposition from the identity, component-wise
    on the covariance ``a`` ([3][3] of tensors, a[r][c]): a fixed trip count
    with a masked update.  The step's axis is omega * (sin(angle/2) *
    (1 / angle)), the JAX grid engine's rounding (the generic engine's
    ``polar.extract_rotation`` divides omega by the angle first)."""
    qx = torch.zeros_like(a[0][0])
    qy, qz = qx, qx
    qw = torch.ones_like(a[0][0])
    for _ in range(iters):
        xx, yy, zz = qx * qx, qy * qy, qz * qz
        xy, xz, yz = qx * qy, qx * qz, qy * qz
        xw, yw, zw = qx * qw, qy * qw, qz * qw
        m = (
            (1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)),
            (2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)),
            (2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)),
        )
        # omega = sum_c cross(R col c, A col c) / (|sum_rc R A| + eps)
        ox = sum(m[1][c] * a[2][c] - m[2][c] * a[1][c] for c in range(3))
        oy = sum(m[2][c] * a[0][c] - m[0][c] * a[2][c] for c in range(3))
        oz = sum(m[0][c] * a[1][c] - m[1][c] * a[0][c] for c in range(3))
        den = torch.abs(
            sum(m[r][c] * a[r][c] for r in range(3) for c in range(3))) + EPS
        ox, oy, oz = ox / den, oy / den, oz / den
        angle = torch.sqrt(ox * ox + oy * oy + oz * oz)
        live = angle >= EPS
        inv = 1.0 / torch.where(live, angle, 1.0)
        half = angle * 0.5
        s = torch.sin(half) * inv
        dx, dy, dz, dw = ox * s, oy * s, oz * s, torch.cos(half)
        nqx, nqy, nqz, nqw = _qmul(dx, dy, dz, dw, qx, qy, qz, qw)
        qx = torch.where(live, nqx, qx)
        qy = torch.where(live, nqy, qy)
        qz = torch.where(live, nqz, qz)
        qw = torch.where(live, nqw, qw)
    return qx, qy, qz, qw


# -- the stencil substep -----------------------------------------------------


def _flat_geometry(g: GridArrays):
    """(nx, gy, gz, gyz, Lc, Nv, offsets[8]) of the flat formulation: a shift
    by (dx, dy, dz) is the flat offset dx*gyz + dy*gz + dz, and cube lanes
    span [nx, gy, gz] (Lc of them, phantoms included)."""
    nx, ny, nz = g.dims
    gy, gz = ny + 1, nz + 1
    gyz = gy * gz
    lc = nx * gyz
    nv = (nx + 1) * gyz
    offs = tuple(dx * gyz + dy * gz + dz for (dx, dy, dz) in g.slab_offsets)
    return nx, gy, gz, gyz, lc, nv, offs


def _cube_valid_mask(g: GridArrays, device=None):
    """f32 [Lc]: 1 on real cubes, 0 on phantom (j == ny or k == nz) lanes."""
    _, _, gz, gyz, lc, _, _ = _flat_geometry(g)
    ny, nz = g.dims[1], g.dims[2]
    r = torch.arange(lc, device=device) % gyz
    ok = ((r // gz) < ny) & ((r % gz) < nz)
    return ok.to(torch.float32)


def tet_deltas(fx, fy, fz, quats, g: GridArrays, iters: int = EXTRACT_ITERS):
    """The tet pass of one Jacobi iteration on flat padded components (see
    ``_solve``): per type t and corner k the rest-volume-weighted goal delta
    ``deltas[t][k]`` = (dx, dy, dz), each [..., Lc], and the new
    quaternions [6][4] of [..., Lc]."""
    _, _, _, _, lc, _, offs = _flat_geometry(g)

    # the 8 shifted corner views
    sx = [fx[..., o:o + lc] for o in offs]
    sy = [fy[..., o:o + lc] for o in offs]
    sz = [fz[..., o:o + lc] for o in offs]

    w = g.rest_volume
    deltas, new_quats = [], []
    for t in range(6):
        ks = g.corner_slab[t]
        cx = [sx[s] for s in ks]
        cy = [sy[s] for s in ks]
        cz = [sz[s] for s in ks]
        ccx = (((cx[0] + cx[1]) + cx[2]) + cx[3]) * 0.25
        ccy = (((cy[0] + cy[1]) + cy[2]) + cy[3]) * 0.25
        ccz = (((cz[0] + cz[1]) + cz[2]) + cz[3]) * 0.25
        pcx = [c - ccx for c in cx]
        pcy = [c - ccy for c in cy]
        pcz = [c - ccz for c in cz]

        qx, qy, qz, qw = quats[t]
        rr = [_qrot_const(g.rest_centered[t][k], qx, qy, qz, qw)
              for k in range(4)]
        # covariance A[r][c] = sum_k cur_k[r] * rest_rot_k[c]
        cur = (pcx, pcy, pcz)
        a = [[sum(cur[r][k] * rr[k][c] for k in range(4)) for c in range(3)]
             for r in range(3)]
        ix, iy, iz, iw = _extract_rotation(a, iters)
        qx, qy, qz, qw = _qmul(ix, iy, iz, iw, qx, qy, qz, qw)
        # the max() bites only on phantom lanes (0/0 would be NaN)
        norm = torch.clamp(torch.sqrt(qx * qx + qy * qy + qz * qz + qw * qw),
                           min=1e-30)
        qx, qy, qz, qw = qx / norm, qy / norm, qz / norm, qw / norm
        new_quats.append((qx, qy, qz, qw))

        goal = [_qrot_const(g.rest_centered[t][k], qx, qy, qz, qw)
                for k in range(4)]
        deltas.append([((goal[k][0] - pcx[k]) * w, (goal[k][1] - pcy[k]) * w,
                        (goal[k][2] - pcz[k]) * w) for k in range(4)])
    return deltas, new_quats


def apply_numerators(fx, fy, fz, numx, numy, numz, g: GridArrays):
    """Movable particles move by num / max(den, eps)."""
    d = torch.clamp(g.den, min=EPS)
    movable = g.inv_mass > 0.0
    return (torch.where(movable, fx + numx / d, fx),
            torch.where(movable, fy + numy / d, fy),
            torch.where(movable, fz + numz / d, fz))


def _solve(fx, fy, fz, quats, g: GridArrays, iters: int = EXTRACT_ITERS,
           halo=None):
    """One Jacobi shape-matching iteration on flat padded components.

    fx/fy/fz: [..., Nv + gyz]; quats: [6][4] of [..., Lc]; ``g`` from
    ``_flat_arrays``.  ``halo``: an optional callback (numx, numy, numz)
    -> (numx, numy, numz) run on the numerators before they are applied;
    the slab stepper completes the boundary planes' partial sums there.
    Returns (fx, fy, fz, new quats)."""
    _, _, _, _, lc, _, offs = _flat_geometry(g)
    mask = _cube_valid_mask(g, fx.device)
    deltas, new_quats = tet_deltas(fx, fy, fz, quats, g, iters)

    # per-slab sums over the types in order
    zero = fx.new_zeros(fx.shape[:-1] + (lc,))
    acc = [[zero] * 8 for _ in range(3)]
    for t in range(6):
        for k, s in enumerate(g.corner_slab[t]):
            for r in range(3):
                acc[r][s] = acc[r][s] + deltas[t][k][r]

    # inverse stencil: phantom lanes masked, slab s added at its offset, in
    # slab order
    def combine(acc):
        out = torch.zeros_like(fx)
        for s, o in enumerate(offs):
            out[..., o:o + lc] += acc[s] * mask
        return out

    numx, numy, numz = (combine(a) for a in acc)
    if halo is not None:
        numx, numy, numz = halo(numx, numy, numz)
    return (*apply_numerators(fx, fy, fz, numx, numy, numz, g), new_quats)


def _substep(carry, g: GridArrays, params: PhysicsParams, dt, grab_id,
             grab_pos, halo=None, x_offset=0):
    """One substep on the flat components: predict, solve, collide, grab,
    velocity.  grab_id [..., G] / grab_pos [..., G, 3] address particles by
    flat id; ``x_offset`` (an int, or a tensor broadcasting against the
    lanes) shifts the local flat ids to global ones on the slab path, and
    ``halo`` goes to ``_solve``.  Returns (new carry, positions at the
    substep's start)."""
    px, py, pz, vx, vy, vz, quats = carry
    movable = g.inv_mass > 0.0

    # predict (common.predict: gravity in prediction, pinned gate)
    vy = vy + params.gravity * dt
    vx = torch.where(movable, vx, 0.0)
    vy = torch.where(movable, vy, 0.0)
    vz = torch.where(movable, vz, 0.0)
    ppx, ppy, ppz = px, py, pz
    px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt

    px, py, pz, quats = _solve(px, py, pz, quats, g, params.extract_iters,
                               halo=halo)

    # collide (common.collide)
    lo, hi = params.world_min, params.world_max
    px = torch.clamp(px, float(lo[0]), float(hi[0]))
    py = torch.clamp(py, float(lo[1]), float(hi[1]))
    pz = torch.clamp(pz, float(lo[2]), float(hi[2]))
    below = py < 0.0
    py = torch.where(below, 0.0, py)
    k = np.minimum(np.float32(1.0), dt * params.friction)
    px = px + torch.where(below, (ppx - px) * k, 0.0)
    pz = pz + torch.where(below, (ppz - pz) * k, 0.0)

    # grab overrides, one slot after another (the last one wins)
    pid = torch.arange(px.shape[-1], device=px.device) + x_offset
    for s in range(grab_id.shape[-1]):
        hit = pid == grab_id[..., s, None]
        px = torch.where(hit, grab_pos[..., s, 0, None], px)
        py = torch.where(hit, grab_pos[..., s, 1, None], py)
        pz = torch.where(hit, grab_pos[..., s, 2, None], pz)

    vx, vy, vz = (common.velocity_update(a, b, dt)
                  for a, b in ((px, ppx), (py, ppy), (pz, ppz)))
    return (px, py, pz, vx, vy, vz, quats), (ppx, ppy, ppz)


# -- kernel layout <-> flat components --------------------------------------
#
# The stencil kernel keeps particle state as planes [B, 3, N] and
# quaternions as [B, 6, 4, C] (C = nx*ny*nz real cubes, C-order); the plain
# engine works on the phantom-padded components above.


def _flat_arrays(g: GridArrays) -> GridArrays:
    """GridArrays with inv_mass / den flattened, den floored at EPS, both
    tail-padded with one phantom x-plane, for ``_solve``."""
    _, _, _, gyz, _, nv, _ = _flat_geometry(g)
    pad = g.inv_mass.new_zeros((gyz,))
    return dataclasses.replace(
        g, inv_mass=torch.cat([g.inv_mass.reshape(nv), pad]),
        den=torch.cat([torch.clamp(g.den.reshape(nv), min=EPS), pad]))


def to_components(pos, vel, quats, g: GridArrays):
    """Kernel layout -> (px, py, pz, vx, vy, vz, quats [6][4] of [B, Lc])."""
    nx, ny, nz = g.dims
    _, gy, gz, gyz, lc, _, _ = _flat_geometry(g)
    b = pos.shape[0]
    pad = pos.new_zeros((b, gyz))
    comps = tuple(torch.cat([a[:, c], pad], dim=-1)
                  for a in (pos, vel) for c in range(3))
    q = quats.reshape(b, 6, 4, nx, ny, nz)
    q = torch.nn.functional.pad(q, (0, 1, 0, 1)).reshape(b, 6, 4, lc)
    return comps + ([tuple(q[:, t, c] for c in range(4)) for t in range(6)],)


def from_components(carry, g: GridArrays):
    """(pos, vel, quats) in the kernel layout from the flat components."""
    nx, ny, nz = g.dims
    _, gy, gz, _, _, nv, _ = _flat_geometry(g)
    px, py, pz, vx, vy, vz, quats = carry
    pos = torch.stack([px[:, :nv], py[:, :nv], pz[:, :nv]], dim=1)
    vel = torch.stack([vx[:, :nv], vy[:, :nv], vz[:, :nv]], dim=1)
    q = torch.stack([torch.stack(quats[t], dim=1) for t in range(6)], dim=1)
    q = q.reshape(-1, 6, 4, nx, gy, gz)[..., :ny, :nz]
    return pos, vel, q.reshape(-1, 6, 4, nx * ny * nz).contiguous()


def planes(x):
    """[..., N, 3] -> [..., 3, N] (contiguous)."""
    return x.transpose(-1, -2).contiguous()


def unplanes(x):
    """[..., 3, N] -> [..., N, 3] (contiguous)."""
    return x.transpose(-1, -2).contiguous()


def quats_to_kernel(quats, g: GridArrays):
    """[..., M, 4] type-major -> [..., 6, 4, C]."""
    c = g.num_tets // 6
    q = quats.reshape(quats.shape[:-2] + (6, c, 4))
    return q.transpose(-1, -2).contiguous()


def quats_from_kernel(q):
    """[..., 6, 4, C] -> [..., 6*C, 4] type-major."""
    q = q.transpose(-1, -2)
    return q.reshape(q.shape[:-3] + (-1, 4)).contiguous()


def frame_reference(pos, vel, quats, g: GridArrays, params: PhysicsParams,
                    grab_id, grab_pos):
    """One frame in plain torch on the kernel layout: pos/vel [B, 3, N],
    quats [B, 6, 4, C], grab_id int32 [B, G], grab_pos [B, G, 3].  Returns
    (pos, prev_pos, vel, quats)."""
    gf = _flat_arrays(g)
    carry = to_components(pos, vel, quats, g)
    prev = pos
    for _ in range(params.num_substeps):
        carry, pp = _substep(carry, gf, params, params.dt, grab_id, grab_pos)
        prev = pp
    nv = g.num_particles
    new_pos, new_vel, new_quats = from_components(carry, g)
    if params.num_substeps:
        prev = torch.stack([c[:, :nv] for c in prev], dim=1)
    return new_pos, prev, new_vel, new_quats


def substep(state: SimState, arr: GridArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One plain-torch substep of ``dt`` on a SimState (any device); its
    diagnostic is 0, as in the JAX engine."""
    gid, gpos = common.norm_grabs(controls)
    gf = _flat_arrays(arr)
    carry = to_components(planes(state.pos)[None], planes(state.vel)[None],
                          quats_to_kernel(state.quats, arr)[None], arr)
    carry, prev = _substep(carry, gf, params, dt, gid[None], gpos[None])
    pos, vel, quats = from_components(carry, arr)
    nv = arr.num_particles
    prev = torch.stack([c[0, :nv] for c in prev], dim=-1)
    return state.replace(pos=unplanes(pos[0]), prev_pos=prev,
                         vel=unplanes(vel[0]),
                         quats=quats_from_kernel(quats[0])), \
        state.pos.new_zeros(())


def step_frame(state: SimState, arr: GridArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = params.num_substeps substeps through
    ``polar_stencil.grid_frame`` (the plain path on a CPU state, the stencil
    kernel on CUDA).  Returns (state, zeros [num_substeps])."""
    from ..kernels import polar_stencil  # imports this module for its twin

    new, _ = polar_stencil.step_frame(state, arr, params, controls)
    return new, state.pos.new_zeros((params.num_substeps,))


# -- x-slab decomposition with a halo exchange --------------------------------
#
# The box is cut into d slabs of lx = nx / d cube columns (``SlabMesh``):
# slab i owns cubes [i*lx, (i+1)*lx) and vertex planes [i*lx, i*lx + lx],
# and the plane shared with each neighbour is stored by both.  Per substep
# the only exchange is one vertex plane of partial numerators per
# neighbour direction and component (3 * gy * gz * 4 bytes each way): each
# owner adds its neighbour's partial sum to its own.  The two copies of a
# shared plane stay bitwise equal (each adds the same two partial sums, and
# IEEE addition is commutative); the sum is re-associated against the
# unsharded engine's slab order, so the trajectories agree to rounding.


@dataclasses.dataclass
class GridSlabState:
    """Per-slab state, one tensor per slab on its slab's device, in the
    stencil kernel's layout: pos, prev and vel [3, (lx+1)*gy*gz] over the
    slab's lx + 1 vertex planes, quats [24, lx*ny*nz] (type t, component c
    at row 4t + c, the slab's cubes in C order)."""

    pos: list
    prev: list
    vel: list
    quats: list


@dataclasses.dataclass
class GridSlabArrays:
    """Per-slab constants [(lx+1)*gy*gz]: the global lumped inverse mass
    and scatter denominator, sliced (a shared plane carries the tets of
    both sides)."""

    inv_mass: list
    den: list


def slab_width(dims, d: int) -> int:
    """lx, the cube columns of each of d slabs; raises unless d divides
    nx."""
    nx = dims[0]
    if nx % d != 0:
        raise ValueError(f"nx={nx} must divide evenly over {d} devices")
    return nx // d


def slab_planes(x, dims, d: int):
    """[C, gx*gy*gz] (C components) -> d slabs [C, (lx+1)*gy*gz], each
    shared plane in both neighbours."""
    lx = slab_width(dims, d)
    gyz = (dims[1] + 1) * (dims[2] + 1)
    x = x.reshape(x.shape[0], dims[0] + 1, gyz)
    return [x[:, i * lx:i * lx + lx + 1].reshape(x.shape[0], -1)
            for i in range(d)]


def unslab_planes(slabs, dims):
    """Inverse of ``slab_planes``: each slab's first lx planes, and the last
    slab's closing plane."""
    d = len(slabs)
    lx = slab_width(dims, d)
    gyz = (dims[1] + 1) * (dims[2] + 1)
    parts = [s.reshape(s.shape[0], lx + 1, gyz)[:, :lx if i < d - 1 else lx + 1]
             for i, s in enumerate(slabs)]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=1).reshape(
        parts[0].shape[0], -1)


def slab_quats(q, dims, d: int):
    """[24, nx*ny*nz] -> d slabs [24, lx*ny*nz]."""
    lx = slab_width(dims, d)
    q = q.reshape(24, dims[0], dims[1] * dims[2])
    return [q[:, i * lx:(i + 1) * lx].reshape(24, -1) for i in range(d)]


def unslab_quats(slabs):
    dev = slabs[0].device
    return torch.cat([s.to(dev) for s in slabs], dim=1)


def grid_prepare(state: SimState, garr: GridArrays, mesh, axis: str = "x"):
    """(SimState, GridArrays) -> (GridSlabState, GridSlabArrays) on
    ``mesh``'s slabs (``axis`` names the mesh's one axis, as in JAX)."""
    del axis
    d, dims = mesh.size, garr.dims

    def slabs(x):
        return mesh.place(slab_planes(planes(x), dims, d))

    q = quats_to_kernel(state.quats, garr).reshape(24, -1)
    st = GridSlabState(pos=slabs(state.pos), prev=slabs(state.prev_pos),
                       vel=slabs(state.vel),
                       quats=mesh.place(slab_quats(q, dims, d)))
    return st, grid_slab_arrays(garr, mesh)


def grid_slab_arrays(garr: GridArrays, mesh) -> GridSlabArrays:
    """The box's inverse masses and scatter denominators, sliced into
    ``mesh``'s slabs on their devices."""
    def slabs(x):
        rows = slab_planes(x.reshape(1, -1), garr.dims, mesh.size)
        return [r[0] for r in mesh.place(rows)]

    return GridSlabArrays(inv_mass=slabs(garr.inv_mass), den=slabs(garr.den))


def grid_unprepare(slab: GridSlabState, garr: GridArrays,
                   n_devices: int) -> SimState:
    """Slab state -> SimState, exactly (each shared plane from its left
    owner, whose copy equals the right one's)."""
    del n_devices  # the slab lists carry their count
    dims = garr.dims
    q = unslab_quats(slab.quats).reshape(6, 4, -1)
    return SimState(pos=unplanes(unslab_planes(slab.pos, dims)),
                    prev_pos=unplanes(unslab_planes(slab.prev, dims)),
                    vel=unplanes(unslab_planes(slab.vel, dims)),
                    quats=quats_from_kernel(q))


def make_grid_sharded_step(mesh, garr: GridArrays, axis: str = "x"):
    """The plain-torch slab frame step over ``mesh``: (GridSlabState,
    GridSlabArrays, params, controls) -> (GridSlabState, zeros
    [num_substeps]).  Each substep is ``_substep`` on every slab at once
    (the slabs stacked on a leading axis, on the mesh's one device) with
    the halo hook: two boundary-plane adds per component (``SlabMesh``)."""
    del axis
    d = mesh.size
    lx = slab_width(garr.dims, d)
    _, ny, nz = garr.dims
    gyz = (ny + 1) * (nz + 1)
    local = dataclasses.replace(garr, dims=(lx, ny, nz))

    def halo(*nums):
        for num in nums:  # [d, (lx+2)*gyz]: the tail plane is padding
            mesh.add_halo([num[i, :gyz] for i in range(d)],
                          [num[i, lx * gyz:(lx + 1) * gyz] for i in range(d)])
        return nums

    def step(slab: GridSlabState, arr: GridSlabArrays, params: PhysicsParams,
             controls: Controls):
        dev = mesh.device()
        gid, gpos = common.norm_grabs(controls)
        gid, gpos = gid.to(dev), gpos.to(dev)
        pad = slab.pos[0].new_zeros((d, gyz))
        g = dataclasses.replace(
            local, inv_mass=torch.cat([torch.stack(arr.inv_mass), pad], -1),
            den=torch.cat([torch.clamp(torch.stack(arr.den), min=EPS), pad],
                          -1))
        x_offset = (torch.arange(d, device=dev) * (lx * gyz))[:, None]
        carry = to_components(torch.stack(slab.pos), torch.stack(slab.vel),
                              torch.stack(slab.quats).reshape(d, 6, 4, -1),
                              local)
        prev = None
        for _ in range(params.num_substeps):
            carry, prev = _substep(carry, g, params, params.dt, gid, gpos,
                                   halo=halo, x_offset=x_offset)
        pos, vel, quats = from_components(carry, local)
        nv = local.num_particles
        prev = (torch.stack(slab.prev) if prev is None
                else torch.stack([c[:, :nv] for c in prev], dim=1))
        new = GridSlabState(pos=mesh.place(pos), prev=mesh.place(prev),
                            vel=mesh.place(vel),
                            quats=mesh.place(quats.reshape(d, 24, -1)))
        return new, pos.new_zeros((params.num_substeps,))

    return step
