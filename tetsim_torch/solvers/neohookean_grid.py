"""Structured-grid Neo-Hookean Gauss-Seidel engine (counterpart of
``tetsim_tpu/solvers/neohookean_grid.py``): the reference-fidelity physics
on ``grid_mesh`` boxes.

Colour = (Kuhn type t, cube parity (i%2, j%2, k%2)): 48 colours, and the
tets of one colour sit in cubes at least 2 apart in every axis, so they
share no vertex and are solved as one batch; the 48-colour sweep
(type-major, parity-minor) is a valid Gauss-Seidel order of the whole mesh.
The state is held in the parity-block layout of the JAX engine: the
vertices split into 8 sub-lattices by parity, each a flat [LHp] block, so
corner k of every tet of a colour lies in one block at one offset and the
gather and the vertex-disjoint scatter are flat slices.  Every sum is
written out in the JAX engine's order; a leading body axis is allowed on
every state array.

``step_frame`` hands the frame to ``kernels/nh_stencil.grid_frame``: on a
CPU tensor that runs this plain-torch path, on a CUDA tensor it launches
the stencil kernel (``kernels/csrc/nh_stencil.cu``), one cooperative
launch per frame.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..mesh import TetMesh
from ..params import PhysicsParams
from ..state import SimState, Controls
from . import common
from .polar_grid import (SLAB_OFFSETS, decode_cube_corners, incidence_count,
                         lumped_inv_mass, planes, slab_planes, unplanes,
                         unslab_planes)

EPS = 1e-9


def grid_coloring(dims) -> np.ndarray:
    """Per-tet colours of a grid_mesh(nx, ny, nz): t*8 + parity(cube), in
    grid_mesh's tet order (type-major, cubes in C order)."""
    nx, ny, nz = dims
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    par = ((ci % 2) * 4 + (cj % 2) * 2 + (ck % 2)).ravel()
    return (np.arange(6, dtype=np.int32)[:, None] * 8
            + par[None, :]).reshape(-1).astype(np.int32)


@dataclasses.dataclass
class NHGridArrays:
    """Stencil-form constants of the Neo-Hookean grid engine: the corner
    offsets and the rest pose (uniform per Kuhn type, host values) and the
    inverse masses on the device, in parity blocks and flat."""

    dims: Tuple[int, int, int]
    corner_slab: Tuple  # [6][4]: offset index of each type's corners
    inv_rest_pose: Tuple  # [6][3][3] floats
    inv_rest_volume: float
    rest_volume: float
    inv_mass_blocks: torch.Tensor  # f32 [8, LHp]
    inv_mass: torch.Tensor  # f32 [Nv]

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

    def to(self, device) -> "NHGridArrays":
        return dataclasses.replace(
            self, inv_mass_blocks=self.inv_mass_blocks.to(device),
            inv_mass=self.inv_mass.to(device))


def _geometry(dims):
    """(H, LH, LHp): parity-block dims (ceil(g/2) each), real block lanes,
    and lanes padded by the largest corner offset HyHz + Hz + 1."""
    gx, gy, gz = dims[0] + 1, dims[1] + 1, dims[2] + 1
    h = ((gx + 1) // 2, (gy + 1) // 2, (gz + 1) // 2)
    lh = h[0] * h[1] * h[2]
    return h, lh, lh + h[1] * h[2] + h[2] + 1


def build_nh_grid_arrays(mesh: TetMesh, dims, density: float = 1000.0,
                         pinned=None, *, device) -> NHGridArrays:
    """The stencil description of a ``grid_mesh(*dims)`` mesh, decoded from
    the mesh's own arrays, with the inverse masses on ``device``."""
    dims = tuple(int(d) for d in dims)
    corner_slab, corners, vol0 = decode_cube_corners(mesh, dims)
    inv_rest_pose = []
    for p in corners:
        d = np.stack([p[1] - p[0], p[2] - p[0], p[3] - p[0]], axis=-1)
        # f64 inverse -> f32, as mesh.rest_state
        ir = np.linalg.inv(d.astype(np.float64)).astype(np.float32)
        inv_rest_pose.append(tuple(tuple(float(x) for x in r) for r in ir))
    w32 = float(np.float32(vol0))
    irv = float(np.float32(1.0 / np.float32(vol0)))
    inv_mass = lumped_inv_mass(incidence_count(dims, corner_slab), vol0,
                               density, pinned).reshape(-1)
    return NHGridArrays(
        dims=dims, corner_slab=corner_slab,
        inv_rest_pose=tuple(inv_rest_pose), inv_rest_volume=irv,
        rest_volume=w32,
        inv_mass_blocks=_to_blocks(torch.as_tensor(inv_mass), dims).to(device),
        inv_mass=torch.as_tensor(inv_mass).to(device),
    )


# -- parity-block layout -------------------------------------------------------


def _to_blocks(flat, dims):
    """[..., Nv] component -> [..., 8, LHp] parity blocks (tail zeros)."""
    gx, gy, gz = dims[0] + 1, dims[1] + 1, dims[2] + 1
    (hx, hy, hz), lh, lhp = _geometry(dims)
    lead = flat.shape[:-1]
    a = flat.new_zeros(lead + (2 * hx, 2 * hy, 2 * hz))
    a[..., :gx, :gy, :gz] = flat.reshape(lead + (gx, gy, gz))
    n = len(lead)
    b = a.reshape(lead + (hx, 2, hy, 2, hz, 2)).permute(
        *range(n), n + 1, n + 3, n + 5, n, n + 2, n + 4).reshape(lead + (8, lh))
    return torch.nn.functional.pad(b, (0, lhp - lh))


def _from_blocks(blocks, dims):
    """[..., 8, LHp] parity blocks -> [..., Nv] flat component."""
    gx, gy, gz = dims[0] + 1, dims[1] + 1, dims[2] + 1
    (hx, hy, hz), lh, _ = _geometry(dims)
    lead = blocks.shape[:-2]
    n = len(lead)
    b = blocks[..., :lh].reshape(lead + (2, 2, 2, hx, hy, hz))
    a = b.permute(*range(n), n + 3, n, n + 4, n + 1, n + 5, n + 2).reshape(
        lead + (2 * hx, 2 * hy, 2 * hz))
    return a[..., :gx, :gy, :gz].reshape(lead + (-1,))


@functools.lru_cache(maxsize=32)
def _block_pid(dims, device=None):
    """Global particle id of each block lane: int64 [8, LH], -2 where the
    lane lies outside the vertex grid (cached per box and device)."""
    gy, gz = dims[1] + 1, dims[2] + 1
    (hx, hy, hz), lh, _ = _geometry(dims)
    lane = torch.arange(lh, device=device)
    zb, yb, xb = lane % hz, (lane // hz) % hy, lane // (hy * hz)
    rows = []
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                i, j, k = 2 * xb + bx, 2 * yb + by, 2 * zb + bz
                valid = (i < dims[0] + 1) & (j < gy) & (k < gz)
                rows.append(torch.where(valid, (i * gy + j) * gz + k, -2))
    return torch.stack(rows)


# -- the 48-colour Gauss-Seidel sweep ----------------------------------------


def _color_plan(arr: NHGridArrays):
    """The 48 colours in sweep order, each (t, parity, [(block, flat
    offset)] * 4, cube window): corner k of the tet in cube p + 2A lies in
    block (p + d) % 2 at block coordinate A + (p + d) // 2."""
    (hx, hy, hz), _, _ = _geometry(arr.dims)
    plan = []
    for t in range(6):
        offs = [SLAB_OFFSETS[s] for s in arr.corner_slab[t]]
        for px in (0, 1):
            for py in (0, 1):
                for pz in (0, 1):
                    p = (px, py, pz)
                    corners = []
                    for d in offs:
                        v = tuple(p[i] + d[i] for i in range(3))
                        b = (v[0] % 2) * 4 + (v[1] % 2) * 2 + (v[2] % 2)
                        a = (v[0] // 2, v[1] // 2, v[2] // 2)
                        corners.append((b, a[0] * hy * hz + a[1] * hz + a[2]))
                    cw = tuple((arr.dims[i] - p[i] + 1) // 2 for i in range(3))
                    plan.append((t, p, tuple(corners), cw))
    return plan


@functools.lru_cache(maxsize=256)
def _cube_mask(cw, dims, device=None):
    """f32 [LH]: 1 where the lane's cube-window coordinates are in range
    (cached per window, box and device)."""
    (hx, hy, hz), lh, _ = _geometry(dims)
    lane = torch.arange(lh, device=device)
    az, ay, ax = lane % hz, (lane // hz) % hy, lane // (hy * hz)
    return ((ax < cw[0]) & (ay < cw[1]) & (az < cw[2])).to(torch.float32)


def _solve_color(p, imc, ir, irv, dt, dev_compliance, vol_compliance):
    """Both Neo-Hookean constraints on one colour's tet lanes.

    p: [4][3] of corner coordinates; imc: [4] inverse masses; ir: [3][3]
    floats (the type's rest pose); irv: float; dt and the compliances: f32
    scalars.  The deviatoric step C = ||F||_F, then the hydrostatic step
    C = det F - 1 - gamma on the updated corners.  Returns (updated p,
    det F - 1)."""
    dt = np.float32(dt)

    def edges(p):
        return [[p[k + 1][r] - p[0][r] for r in range(3)] for k in range(3)]

    def deformation(e):
        return [[sum(e[k][r] * ir[k][c] for k in range(3)) for c in range(3)]
                for r in range(3)]

    def xpbd_apply(p, g, c_val, compliance):
        g0 = [-(g[0][r] + g[1][r] + g[2][r]) for r in range(3)]
        gall = [g0] + list(g)
        w = sum((gall[i][0] * gall[i][0] + gall[i][1] * gall[i][1]
                 + gall[i][2] * gall[i][2]) * imc[i] for i in range(4))
        alpha = np.float32(np.float32(compliance) / (dt * dt)) \
            * np.float32(irv)
        ok = (c_val != 0.0) & (w != 0.0)
        denom = torch.where(ok, w + alpha, 1.0)
        dlam = torch.where(ok, -c_val / denom, 0.0)
        return [[p[i][r] + dlam * imc[i] * gall[i][r] for r in range(3)]
                for i in range(4)]

    gamma = np.float32(vol_compliance) / np.float32(dev_compliance)

    # deviatoric: C = ||F||_F
    f = deformation(edges(p))
    r_s = torch.sqrt(sum(f[r][c] * f[r][c] for r in range(3)
                         for c in range(3)))
    r_inv = torch.where(r_s > 0.0, 1.0 / torch.where(r_s > 0.0, r_s, 1.0),
                        0.0)
    g = [[sum(f[r][c] * ir[i][c] for c in range(3)) * r_inv for r in range(3)]
         for i in range(3)]
    p = xpbd_apply(p, g, r_s, dev_compliance)

    # hydrostatic: C = det F - 1 - gamma on the updated positions
    f = deformation(edges(p))

    def col(c):
        return [f[r][c] for r in range(3)]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    f0, f1, f2 = col(0), col(1), col(2)
    df = [cross(f1, f2), cross(f2, f0), cross(f0, f1)]
    det = sum(f[r][0] * df[0][r] for r in range(3))
    c_vol = det - 1.0 - gamma
    g = [[sum(df[c][r] * ir[i][c] for c in range(3)) for r in range(3)]
         for i in range(3)]
    p = xpbd_apply(p, g, c_vol, vol_compliance)
    return p, det - 1.0


def _gs_sweep(X, Y, Z, arr: NHGridArrays, dt, params: PhysicsParams,
              exchange=None):
    """The 48-colour sweep on parity-block state [..., 8, LHp], colours in
    order, each colour's tets at once, written back in place (the tets of a
    colour share no vertex).  Returns (X, Y, Z, sum of masked det F - 1).

    ``exchange(X, Y, Z, to_px)`` (the slab stepper) is called at every
    cube-x-parity flip of the colour plan and once after the sweep: with
    slab cuts at even cube columns a px=0 colour updates a shared vertex
    plane only on the right slab and a px=1 colour only on the left, so
    refreshing the stale copy at those 12 points per substep gives the
    unsharded sweep exactly.

    Lanes outside a colour's cube window are dropped with ``where``, not
    multiplied by a 0/1 mask as in the JAX engine: their corners are
    padding, and the degenerate tets they make can give inf or NaN once
    denormals are kept (torch keeps them; XLA on the CPU flushes them)."""
    _, lh, _ = _geometry(arr.dims)
    X, Y, Z = X.clone(), Y.clone(), Z.clone()
    vol_err = X.new_zeros(X.shape[:-2])
    last_px = None
    for t, p, corners, cw in _color_plan(arr):
        if exchange is not None and last_px is not None and p[0] != last_px:
            X, Y, Z = exchange(X, Y, Z, p[0])
        last_px = p[0]
        ok = _cube_mask(cw, arr.dims, X.device) > 0.0
        pc = [[comp[..., b, o:o + lh].clone() for comp in (X, Y, Z)]
              for (b, o) in corners]
        imc = [arr.inv_mass_blocks[..., b, o:o + lh] for (b, o) in corners]
        newp, verr = _solve_color(pc, imc, arr.inv_rest_pose[t],
                                  arr.inv_rest_volume, dt,
                                  params.dev_compliance, params.vol_compliance)
        for k, (b, o) in enumerate(corners):
            for c, comp in enumerate((X, Y, Z)):
                comp[..., b, o:o + lh] += torch.where(
                    ok, newp[k][c] - pc[k][c], 0.0)
        vol_err = vol_err + torch.where(ok, verr, 0.0).sum(dim=-1)
    if exchange is not None:
        # the last px=1 colours updated the shared planes on the left slabs:
        # refresh the right copies before collide
        X, Y, Z = exchange(X, Y, Z, 0)
    return X, Y, Z, vol_err


def predict_phase(imc, X, Y, Z, VX, VY, VZ, params: PhysicsParams, dt):
    """Predict (common.predict: gravity in prediction, pinned gate).
    Returns (X, Y, Z, VX, VY, VZ); the previous positions are the inputs."""
    movable = imc > 0.0
    VY = VY + params.gravity * dt
    VX = torch.where(movable, VX, 0.0)
    VY = torch.where(movable, VY, 0.0)
    VZ = torch.where(movable, VZ, 0.0)
    return X + VX * dt, Y + VY * dt, Z + VZ * dt, VX, VY, VZ


def collide_grab_phase(X, Y, Z, PX, PY, PZ, pid, params: PhysicsParams, dt,
                       grab_id, grab_pos):
    """Collide, grab override (grab_id [..., G] against the particle ids
    ``pid``; the last slot wins) and the velocity update."""
    lo, hi = params.world_min, params.world_max
    X = torch.clamp(X, float(lo[0]), float(hi[0]))
    Y = torch.clamp(Y, float(lo[1]), float(hi[1]))
    Z = torch.clamp(Z, float(lo[2]), float(hi[2]))
    below = Y < 0.0
    Y = torch.where(below, 0.0, Y)
    k = np.minimum(np.float32(1.0), dt * params.friction)
    X = X + torch.where(below, (PX - X) * k, 0.0)
    Z = Z + torch.where(below, (PZ - Z) * k, 0.0)
    extra = (None,) * pid.dim()
    for s in range(grab_id.shape[-1]):
        hit = pid == grab_id[(..., s) + extra]
        X = torch.where(hit, grab_pos[(..., s, 0) + extra], X)
        Y = torch.where(hit, grab_pos[(..., s, 1) + extra], Y)
        Z = torch.where(hit, grab_pos[(..., s, 2) + extra], Z)
    return X, Y, Z, *(common.velocity_update(a, b, dt)
                      for a, b in ((X, PX), (Y, PY), (Z, PZ)))


def _substep_blocks(carry, arr: NHGridArrays, params: PhysicsParams, dt,
                    grab_id, grab_pos, exchange=None, x_offset=None):
    """One substep on parity-block state.  ``exchange`` goes to the sweep;
    ``x_offset`` (a tensor broadcasting against the lanes) shifts the local
    particle ids of the grab decode to global ones on the slab path.
    Returns (new carry, (previous positions, vol_err / num_tets))."""
    X, Y, Z, VX, VY, VZ = carry
    PX, PY, PZ = X, Y, Z
    X, Y, Z, VX, VY, VZ = predict_phase(arr.inv_mass_blocks, X, Y, Z, VX, VY,
                                        VZ, params, dt)
    X, Y, Z, vol_err = _gs_sweep(X, Y, Z, arr, dt, params, exchange)
    _, lh, lhp = _geometry(arr.dims)
    pid = torch.nn.functional.pad(_block_pid(arr.dims, X.device),
                                  (0, lhp - lh), value=-2)
    if x_offset is not None:
        pid = torch.where(pid >= 0, pid + x_offset, pid)
    carry = collide_grab_phase(X, Y, Z, PX, PY, PZ, pid, params, dt, grab_id,
                               grab_pos)
    return carry, ((PX, PY, PZ), vol_err / arr.num_tets)


def frame_reference(pos, vel, arr: NHGridArrays, params: PhysicsParams,
                    grab_id, grab_pos):
    """One frame in plain torch on the kernel layout: pos/vel [B, 3, N],
    grab_id int32 [B, G], grab_pos [B, G, 3].  Returns (pos, prev_pos, vel,
    vol_err [B, num_substeps])."""
    d = arr.dims
    carry = tuple(_to_blocks(a[:, c], d) for a in (pos, vel) for c in range(3))
    prev, errs = pos, []
    for _ in range(params.num_substeps):
        carry, (pp, err) = _substep_blocks(carry, arr, params, params.dt,
                                           grab_id, grab_pos)
        prev = torch.stack([_from_blocks(c, d) for c in pp], dim=1)
        errs.append(err)
    pos = torch.stack([_from_blocks(c, d) for c in carry[:3]], dim=1)
    vel = torch.stack([_from_blocks(c, d) for c in carry[3:]], dim=1)
    vol_err = (torch.stack(errs, dim=-1) if errs
               else pos.new_zeros((pos.shape[0], 0)))
    return pos, prev, vel, vol_err


def substep(state: SimState, arr: NHGridArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One plain-torch substep of ``dt`` on a SimState (any device).
    Returns (state, vol_err / num_tets)."""
    gid, gpos = common.norm_grabs(controls)
    d = arr.dims
    carry = tuple(_to_blocks(a[:, c], d) for a in (state.pos, state.vel)
                  for c in range(3))
    carry, (pp, err) = _substep_blocks(carry, arr, params, dt, gid, gpos)

    def stack3(x):
        return torch.stack([_from_blocks(c, d) for c in x], dim=-1)

    return state.replace(pos=stack3(carry[:3]), prev_pos=stack3(pp),
                         vel=stack3(carry[3:])), err


def step_frame(state: SimState, arr: NHGridArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = params.num_substeps substeps through
    ``nh_stencil.grid_frame`` (the plain path on a CPU state, the stencil
    kernels on CUDA).  Returns (state, vol_err / num_tets [num_substeps])."""
    from ..kernels import nh_stencil  # imports this module for its twin

    gid, gpos = common.norm_grabs(controls)
    pos, prev, vel, vol_err = nh_stencil.grid_frame(
        planes(state.pos)[None], planes(state.vel)[None], arr, params,
        gid[None], gpos[None], vol_err=True)
    return state.replace(pos=unplanes(pos[0]), prev_pos=unplanes(prev[0]),
                         vel=unplanes(vel[0])), vol_err[0]


# -- x-slab decomposition ------------------------------------------------------
#
# Gauss-Seidel is sequential over colours, so the polar engine's one halo
# per substep cannot reproduce its trajectory.  The colour plan makes an
# exact cut possible: with slab cuts at even cube columns, a px=0 colour
# updates a shared vertex plane only from the right slab and a px=1 colour
# only from the left, and no colour reads a vertex the other slab updated
# within the same px group.  Refreshing the stale copy at the plan's px
# flips (12 one-plane copies per substep, ``SlabMesh`` moves) gives the
# unsharded 48-colour trajectory exactly.


def _slab_geometry(dims, d: int):
    """(lx, local dims) of d slabs; raises unless d divides nx into even
    cube columns (one slab may hold any count)."""
    nx, ny, nz = dims
    if nx % d != 0:
        raise ValueError(f"nx={nx} must divide evenly over {d} slabs")
    lx = nx // d
    if d > 1 and lx % 2 != 0:
        raise ValueError(
            f"cubes per slab must be even for parity-aligned cuts "
            f"(nx={nx}, {d} slabs -> {lx})")
    return lx, (lx, ny, nz)


def nh_prepare(state: SimState, arr: NHGridArrays, d):
    """SimState -> slab state (pos, vel): two lists of d tensors
    [3, (lx+1)*gy*gz] in the stencil kernels' plane layout, the shared
    planes in both neighbours.  ``d`` is a ``SlabMesh`` (each slab on its
    device) or a slab count (on the state's device)."""
    mesh = d if hasattr(d, "place") else None
    n = mesh.size if mesh is not None else int(d)
    _slab_geometry(arr.dims, n)

    def slabs(x):
        out = slab_planes(planes(x), arr.dims, n)
        return mesh.place(out) if mesh is not None else out

    return slabs(state.pos), slabs(state.vel)


def nh_unprepare(slab, arr: NHGridArrays, d: int,
                 params: PhysicsParams) -> SimState:
    """Slab state -> SimState: each slab's first lx planes and the last
    slab's closing plane (the copies are equal at frame ends), prev_pos
    re-derived as pos - vel * dt and identity quaternions, as the JAX
    package does."""
    _slab_geometry(arr.dims, d)
    pos = unplanes(unslab_planes(slab[0], arr.dims))
    vel = unplanes(unslab_planes(slab[1], arr.dims))
    quats = pos.new_zeros((arr.num_tets, 4))
    quats[:, 3] = 1.0
    return SimState(pos=pos, prev_pos=pos - vel * params.dt, vel=vel,
                    quats=quats)


def slab_inv_mass(arr: NHGridArrays, d: int):
    """The global lumped inverse masses sliced into d slabs [(lx+1)*gy*gz]
    (a shared plane carries the tets of both sides)."""
    return [r[0] for r in slab_planes(arr.inv_mass.reshape(1, -1), arr.dims,
                                      d)]


def make_nh_sharded_step(mesh, arr: NHGridArrays, axis: str = "x"):
    """The plain-torch slab frame step over ``mesh``: (slab state, params,
    controls) -> (slab state, mean vol_err [num_substeps]).  Each substep
    is ``_substep_blocks`` on every slab at once (stacked on a leading
    axis, on the mesh's one device) with the exchange hook; the diagnostic
    is the global mean, the slabs' local means renormalised as JAX's psum
    does."""
    del axis
    d = mesh.size
    lx, local_dims = _slab_geometry(arr.dims, d)
    (_, hy, hz), _, _ = _geometry(local_dims)
    hyz = hy * hz
    last = (lx // 2) * hyz  # plane x = lx: block row 0..3, block x lx / 2
    gyz = (arr.dims[1] + 1) * (arr.dims[2] + 1)
    tets_local = 6 * lx * arr.dims[1] * arr.dims[2]
    im = torch.stack(slab_inv_mass(arr, d))
    local = dataclasses.replace(arr, dims=local_dims, inv_mass=im,
                                inv_mass_blocks=_to_blocks(im, local_dims))

    def exchange(X, Y, Z, to_px):
        for A in (X, Y, Z):  # [d, 8, LHp]
            lo = [A[i, 0:4, 0:hyz] for i in range(d)]
            hi = [A[i, 0:4, last:last + hyz] for i in range(d)]
            if to_px == 1:
                mesh.send_left(lo, hi)  # right's plane 0 -> plane lx
            else:
                mesh.send_right(hi, lo)  # left's plane lx -> plane 0
        return X, Y, Z

    def step(slab, params: PhysicsParams, controls: Controls):
        dev = mesh.device()
        arr_l = local.to(dev)
        gid, gpos = common.norm_grabs(controls)
        gid, gpos = gid.to(dev), gpos.to(dev)
        carry = tuple(_to_blocks(torch.stack(a)[:, c], local_dims)
                      for a in slab for c in range(3))
        x_offset = (torch.arange(d, device=dev) * (lx * gyz))[:, None, None]
        errs = []
        for _ in range(params.num_substeps):
            carry, (_, err) = _substep_blocks(
                carry, arr_l, params, params.dt, gid, gpos,
                exchange=exchange, x_offset=x_offset)
            errs.append(err)
        diags = ((torch.stack(errs, dim=-1) * np.float32(tets_local)).sum(0)
                 / np.float32(arr.num_tets) if errs
                 else torch.zeros((0,), device=dev))
        pos, vel = (torch.stack([_from_blocks(c, local_dims) for c in part],
                                dim=1) for part in (carry[:3], carry[3:]))
        return (mesh.place(pos), mesh.place(vel)), diags

    return step
