"""Scene API (counterpart of ``tetsim_tpu/world.py``): bodies are added to
a ``World`` on one device, ``world.step(frames)`` advances every body, and
render data (skinned surface vertices, normals) is computed on the device
and brought to the host on demand.

Every entry point runs on the card unless the caller passes
``device="cpu"``; where CUDA is missing, asking for it raises.  Stepping
never waits for the device: ``positions``, ``surface_mesh``,
``diagnostics`` and ``start_grab`` (which returns the grabbed id) are the
calls that synchronise.  This package carries the Neo-Hookean and polar
engines: ``Body`` runs either through its solver (one fused-kernel launch
per frame on CUDA; where the body outgrows one block's shared memory, one
cluster launch per frame (Neo-Hookean) or a multi-block kernel per pass
(polar)), ``add_body_batch`` runs
``FusedGSBody``, ``FusedPolarBody`` or ``BatchedBody``.  ``add_grid_body``
runs a
``grid_mesh`` box through the stencil engines (``Body`` with grid arrays,
or ``PackedGridBody``, whose state stays in the kernels' layout), and
``add_grid_body_batch`` steps B boxes at once (``GridBodyBatch``).  One
large unstructured mesh runs through ``Body`` with the pieces engines
(``engine="polar_pieces"`` or ``"nh_pieces"``, the kernels of
``kernels/polar_pieces.py`` and ``kernels/nh_pieces.py``), and
``add_body_batch(..., backend="fused_ordered")`` steps 8 bodies in the
reference's exact constraint order (``OrderedGSBody``), and
``add_body_batch(..., backend="dense")`` B bodies batched in columns
through the dense engine (``DenseBody``, ``solvers/dense.py``), or with
``backend="dense_ordered"`` on its order-preserving levels.

``enable_render_export`` / ``step_many_export`` run a body's frames and
then its surface export ([2, S, 3]: skinned vertices and normals) as one
call with no host sync, the viewer's per-frame path.  ``World.save`` /
``restore`` / ``load`` write and read a scene checkpoint in the JAX
package's format (``checkpoint.py``).  While a profiler session records,
``World.step``, each ``step_many_export``, the grab calls and the export
open the ``tetsim.*`` spans of ``spans.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import diag
from .kernels import (gs_fused, gs_levels, nh_pieces, polar_fused,
                      polar_jacobi, polar_pieces)
from .kernels.batch import SMEM_LIMIT, FusedBatch
from .kernels.gs_fused import FusedGSBody
from .kernels.gs_ordered import OrderedGSBody
from .kernels.polar_fused import FusedPolarBody
from .mesh import (TetArrays, TetMesh, build_arrays, grid_mesh, replicate_mesh,
                   with_boundary_surface)
from .params import PhysicsParams
from .solvers import GRID_ENGINES, dense, get_engine
from .solvers.neohookean_grid import build_nh_grid_arrays
from .solvers.polar import quat_rotate
from .solvers.polar_grid import (build_grid_arrays, planes, quats_from_kernel,
                                 unplanes)
from .spans import (EXPORT, EXPORT_NORMALS, EXPORT_POSITIONS, EXPORT_SKIN,
                    GRAB_END, GRAB_MOVE, GRAB_START, STEP_EXPORT, WORLD_STEP,
                    span)
from .state import Controls, SimState, check_device, init_state
from .utils import mat3


def _point(point, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(point, np.float32)).to(device)


def _nearest_particle(pos, point):
    """Index (int32 scalar tensor, on pos's device) of the particle nearest
    to ``point``."""
    return torch.argmin(((pos - point) ** 2).sum(dim=-1)).to(torch.int32)


def _skin_surface(pos, skin_ids, skin_w):
    """Barycentric surface skinning: a surface vertex is its tet's 4 corner
    positions weighted by (b0, b1, b2, 1-b0-b1-b2), summed as fused
    multiply-adds in corner order (how XLA rounds the JAX package's
    skinning, so both give the same vertices from the same positions)."""
    corners, w = pos[skin_ids], skin_w[..., None]  # [S,4,3], [S,4,1]
    out = corners[:, 0] * w[:, 0]
    for c in range(1, 4):
        out = torch.addcmul(out, corners[:, c], w[:, c])
    return out


def _vertex_normals(verts, tris):
    """Area-weighted vertex normals, accumulated with index_add_."""
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = mat3.cross(p1 - p0, p2 - p0)  # area-weighted
    n = torch.zeros_like(verts)
    for k in range(3):
        n.index_add_(0, tris[:, k], fn)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / norm.clamp(min=1e-12)


def _rotated_normals(rest_normals, quats, vis_tet_ids):
    """The reference GPU path's normals: each surface vertex's rest normal
    rotated by its tet's shape-matching quaternion."""
    return quat_rotate(rest_normals, quats[vis_tet_ids])


def _surface_render_data(pos, skin_ids, skin_w, tris):
    """The viewer's export: skinned vertices and smooth normals stacked as
    one [2,S,3] device tensor (the ``tetsim.export.skin`` and ``.normals``
    spans; the caller opens ``tetsim.export``)."""
    with span(EXPORT_SKIN):
        verts = _skin_surface(pos, skin_ids, skin_w)
    with span(EXPORT_NORMALS):
        normals = _vertex_normals(verts, tris)
    return torch.stack([verts, normals])


def _surface_render_data_rotated(pos, skin_ids, skin_w, rest_normals, quats,
                                 vis_tet_ids):
    """The viewer's export with the reference GPU path's shading: skinned
    vertices and the rest normals rotated by each tet's quaternion, [2,S,3]."""
    with span(EXPORT_SKIN):
        verts = _skin_surface(pos, skin_ids, skin_w)
    with span(EXPORT_NORMALS):
        normals = _rotated_normals(rest_normals, quats, vis_tet_ids)
    return torch.stack([verts, normals])


_POLAR_ENGINES = ("polar", "polar_grid", "polar_pieces")


def _make_many_export(step_many, positions, quats):
    """The fused N frames + surface export of Body, BatchedBody and
    GridBodyBatch: ``step_many(params, frames)`` advances the body,
    ``positions()`` gives its flat [P,3] device positions and ``quats()``
    its flat per-tet quaternions, or None where the engine carries none
    (then normals="rotated" falls back to smooth, as in the JAX package).
    The returned ``many(surf, params, frames, normals)`` gives the [2,S,3]
    device export without a host sync."""

    def many(surf, params, frames, normals):
        step_many(params, frames)
        with span(EXPORT):
            with span(EXPORT_POSITIONS):
                pos = positions()
                q = quats() if normals == "rotated" else None
            if q is not None:
                return _surface_render_data_rotated(
                    pos, surf.skin_ids, surf.skin_w, surf.rest_normals, q,
                    surf.vis_tet_ids)
            return _surface_render_data(pos, surf.skin_ids, surf.skin_w,
                                        surf.tris)

    return many


class _Surface:
    """Embedded-surface render tables + skinning for one (possibly
    flattened multi-body) mesh."""

    def __init__(self, mesh: TetMesh, device):
        self.skin_ids = torch.as_tensor(
            mesh.tets[mesh.vis_tet_ids].astype(np.int64)).to(device)  # [S,4]
        b = mesh.vis_bary
        w = np.concatenate([b, 1.0 - b.sum(axis=1, keepdims=True)], axis=1)
        self.skin_w = torch.as_tensor(w.astype(np.float32)).to(device)  # [S,4]
        self.tris_np = np.asarray(mesh.tris, np.int32)
        self.tris = torch.as_tensor(self.tris_np.astype(np.int64)).to(device)
        self.vis_tet_ids = torch.as_tensor(
            mesh.vis_tet_ids.astype(np.int64)).to(device)
        rest = torch.as_tensor(mesh.verts.astype(np.float32)).to(device)
        self.rest_normals = _vertex_normals(
            _skin_surface(rest, self.skin_ids, self.skin_w), self.tris)

    def positions(self, pos) -> np.ndarray:
        return _skin_surface(pos, self.skin_ids, self.skin_w).cpu().numpy()

    def mesh_data(self, pos, quats=None, normals: str = "smooth"):
        """(verts [S,3], normals [S,3], tris [T,3]) as numpy, one transfer.
        normals="smooth" recomputes area-weighted normals from the deformed
        surface; "rotated" rotates the rest normals by the per-tet
        quaternions ``quats`` (polar engine only)."""
        if normals == "rotated" and quats is None:
            raise ValueError(
                "rotated normals need per-tet quaternions (polar engine)")
        if normals not in ("smooth", "rotated"):
            raise ValueError(f"unknown normals mode {normals!r}")
        with span(EXPORT):
            if normals == "smooth":
                vn = _surface_render_data(pos, self.skin_ids, self.skin_w,
                                          self.tris)
            else:
                vn = _surface_render_data_rotated(
                    pos, self.skin_ids, self.skin_w, self.rest_normals, quats,
                    self.vis_tet_ids)
        vn = vn.cpu().numpy()
        return vn[0], vn[1], self.tris_np

    def render_data(self, pos) -> np.ndarray:
        """Stacked [2,S,3] (vertices, smooth normals) in one device-to-host
        transfer."""
        with span(EXPORT):
            vn = _surface_render_data(pos, self.skin_ids, self.skin_w,
                                      self.tris)
        return vn.cpu().numpy()


_PIECES_BUILDERS = {"polar_pieces": polar_pieces.build_pieces_arrays,
                    "nh_pieces": nh_pieces.build_nh_pieces_arrays}


class Body:
    """One soft body: mesh constants + simulation state + interaction.  The
    pieces engines build their tables with the pins baked in (default
    layout, 2,048 tets per piece); pass ``arrays=`` for another.  A
    neohookean or polar body runs its frames through ``kernel``: the fused
    frame kernel (``gs_fused``, ``polar_fused``) where the body fits one
    block's shared memory, else ``gs_levels`` / ``polar_jacobi``."""

    def __init__(
        self,
        mesh: TetMesh,
        engine: str = "neohookean",
        coloring: Optional[str] = "auto",
        density: float = 1000.0,
        arrays: Optional[TetArrays] = None,
        pinned=None,
        device="cuda",
    ):
        self.engine_mod = get_engine(engine)
        self.mesh = mesh
        self.engine = engine
        self.device = check_device(device)
        if coloring == "auto":
            # polar is Jacobi: no GS schedule
            coloring = "ordered" if engine == "neohookean" else None
        grid = engine in GRID_ENGINES
        pieces = engine in _PIECES_BUILDERS
        if pieces and arrays is None:
            arrays = _PIECES_BUILDERS[engine](mesh, density=density,
                                              pinned=pinned, device=self.device)
            pinned = None
        if grid and arrays is None:
            raise ValueError(
                f"the {engine} engine needs stencil arrays: pass "
                "arrays=build_grid_arrays(mesh, (nx,ny,nz), device=...) (or "
                "build_nh_grid_arrays): the cube dims are not derivable "
                "from a flat TetMesh (or use World.add_grid_body)"
            )
        if arrays is not None and pinned is not None:
            raise ValueError(
                "pinned= has no effect when arrays= is prebuilt — bake the "
                "pins in (build_arrays/build_grid_arrays take pinned=)"
            )
        # the kernel module of a neohookean or polar body's frames: the
        # fused frame kernel where the body fits one block's shared memory,
        # else the multi-block kernels (on a CPU state all run the same
        # plain path)
        self.kernel = None
        self._step_frame = self.engine_mod.step_frame
        if not (grid or pieces):
            fused, large = ((polar_fused, polar_jacobi) if engine == "polar"
                            else (gs_fused, gs_levels))
            fits = fused.smem_bytes(mesh.num_particles) <= SMEM_LIMIT
            self.kernel = fused if fits else large
            if not fits:
                self._step_frame = large.step_frame
        self.arrays = (
            arrays.to(self.device) if arrays is not None
            else build_arrays(mesh, density=density, coloring=coloring,
                              pinned=pinned, device=self.device)
        )
        self.state = init_state(mesh, self.device)
        self.controls = Controls.none(self.device)
        self.last_diag: Optional[torch.Tensor] = None
        self._surface = (
            _Surface(mesh, self.device) if mesh.vis_tet_ids is not None else None
        )
        self._many_export = None

    # -- stepping ---------------------------------------------------------
    def step(self, params: PhysicsParams):
        """One frame; returns its vol_errs [num_substeps] (device tensor)."""
        self.state, self.last_diag = self._step_frame(
            self.state, self.arrays, params, self.controls
        )
        return self.last_diag

    def step_many(self, params: PhysicsParams, frames: int):
        """``frames`` frames; diagnostics carry the last frame's."""
        for _ in range(frames):
            self.step(params)
        return self.last_diag

    def enable_render_export(self):
        """Set up ``step_many_export``: frames and surface export in one
        call."""
        self._need_surface()
        self._many_export = _make_many_export(
            self.step_many, lambda: self.state.pos,
            lambda: (self.state.quats if self.engine in _POLAR_ENGINES
                     else None))

    def step_many_export(self, params: PhysicsParams, frames: int,
                         normals: str = "smooth"):
        """``frames`` frames, then the surface export: returns the device
        [2,S,3] (vertices, normals) without a host sync.  Needs a prior
        ``enable_render_export``."""
        if self._many_export is None:
            raise RuntimeError("call enable_render_export() first")
        with span(STEP_EXPORT):
            vn = self._many_export(self._surface, params, frames, normals)
        self.last_diag = None
        return vn

    def simulate(self, dt, params: Optional[PhysicsParams] = None):
        """The reference API's simulate(dt, physicsParams): one substep of
        length ``dt``.  ``step`` runs a whole frame in one call."""
        one = dataclasses.replace(params or PhysicsParams(), time_step=dt,
                                  time_scale=1.0, num_substeps=1)
        return self.step(one)

    def end_frame(self):
        """The reference API's endFrame: (positions [N,3], skinned surface
        vertices [S,3] or None)."""
        surface = (self.surface_positions() if self._surface is not None
                   else None)
        return self.positions, surface

    # -- interaction --------------------------------------------------------
    def start_grab(self, point) -> int:
        """Grab the particle nearest to ``point``; returns its id."""
        with span(GRAB_START):
            p = _point(point, self.device)
            gid = _nearest_particle(self.state.pos, p)
            self.controls = Controls(grab_id=gid, grab_pos=p)
            return int(gid)

    def move_grabbed(self, point):
        with span(GRAB_MOVE):
            self.controls = self.controls.replace(
                grab_pos=_point(point, self.device))

    def end_grab(self):
        with span(GRAB_END):
            self.controls = Controls.none(self.device)

    # -- render-data export --------------------------------------------------
    @property
    def positions(self) -> np.ndarray:
        """Particle positions [N,3]."""
        return self.state.pos.cpu().numpy()

    def _need_surface(self) -> _Surface:
        if self._surface is None:
            raise ValueError("mesh has no embedded render surface")
        return self._surface

    def surface_positions(self) -> np.ndarray:
        """Skinned embedded-surface vertices [S,3]."""
        return self._need_surface().positions(self.state.pos)

    def surface_mesh(self, normals: str = "smooth"):
        """(positions [S,3], normals [S,3], triangles [T,3]) for a viewer,
        computed on the device and brought over in one transfer.
        normals="smooth" recomputes them from the deformed surface (the
        reference CPU path); "rotated" rotates the rest normals by each tet's
        quaternion (the reference GPU path; polar engine only)."""
        quats = self.state.quats if self.engine == "polar" else None
        return self._need_surface().mesh_data(self.state.pos, quats, normals)


class BatchedBody(FusedBatch):
    """N bodies of one mesh as one flattened disjoint mesh, body-major
    (``replicate_mesh``): flat particle ``b * N + i`` is particle i of body
    b, and the surface of all bodies is one concatenated mesh.  Each body
    has one grab slot; ``positions`` is a property, as in the JAX package.

    The bodies step as a [B, N] batch of one fused frame kernel with the
    single mesh's tables, one block per body: the polar engine through
    ``polar_fused.polar_frame`` (a particle's incident corners keep their
    order), the neohookean engine through ``gs_fused.gs_frame`` on the
    ordered schedule.  The flat mesh is disjoint and body-major, so its
    order-preserving levels are each body's own levels, and the batch gives
    the numbers the flat mesh would; a flat mesh of 8 dragons (9,872
    particles, 355 KB of particle planes) would not fit one block's shared
    memory.  So this is a fused batch with the flat layout's surface and
    grab by flat particle id; ``quats`` is None for the neohookean
    engine."""

    def __init__(
        self,
        mesh: TetMesh,
        num_bodies: int,
        engine: str = "polar",
        density: float = 1000.0,
        jitter: float = 0.0,
        seed: int = 0,
        device="cuda",
    ):
        if engine not in ("polar", "neohookean"):
            raise ValueError(
                f"BatchedBody(engine={engine!r}): flat batches run the polar "
                "and neohookean engines"
            )
        polar = engine == "polar"
        (polar_fused if polar else gs_fused).check_fits(mesh.num_particles)
        super().__init__(mesh, num_bodies, jitter, seed, device)
        self.engine = engine
        self.arrays = build_arrays(mesh, density,
                                   coloring=None if polar else "ordered",
                                   device=self.device)
        self.quats = None
        if polar:
            self.quats = torch.zeros((num_bodies, mesh.num_tets, 4),
                                     dtype=torch.float32, device=self.device)
            self.quats[..., 3] = 1.0
        self.last_diag: Optional[torch.Tensor] = None
        self.flat_mesh = replicate_mesh(mesh, num_bodies, jitter=jitter, seed=seed)
        self._surface = (
            _Surface(self.flat_mesh, self.device)
            if self.flat_mesh.vis_tet_ids is not None else None
        )
        self._many_export = None

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every body by ``frames`` frames (no sync); the neohookean
        engine keeps the last frame's vol_err [num_bodies, num_substeps]."""
        for _ in range(frames):
            if self.quats is None:
                self.pos, self.prev_pos, self.vel, self.last_diag = (
                    gs_fused.gs_frame(self.pos, self.vel, self.arrays, params,
                                      self.grab_id, self.grab_pos))
            else:
                self.pos, self.prev_pos, self.vel, self.quats = (
                    polar_fused.polar_frame(
                        self.pos, self.vel, self.quats, self.arrays, params,
                        self.grab_id, self.grab_pos))
        return self.last_diag

    def _flat_quats(self):
        return None if self.quats is None else self.quats.reshape(-1, 4)

    def quaternions(self) -> np.ndarray:
        """[num_bodies, M, 4] per-tet quaternions (polar engine)."""
        if self.quats is None:
            raise ValueError("the neohookean engine carries no quaternions")
        return self.quats.cpu().numpy()

    def enable_render_export(self):
        """Set up ``step_many_export`` for the whole batch's surface."""
        if self._surface is None:
            raise ValueError("mesh has no embedded render surface")
        self._many_export = _make_many_export(
            self.step, lambda: self.pos.reshape(-1, 3), self._flat_quats)

    def step_many_export(self, params: PhysicsParams, frames: int,
                         normals: str = "smooth"):
        """``frames`` frames, then the batch's surface export [2,B*S,3]
        (device tensor, no sync; see ``Body.step_many_export``)."""
        if self._many_export is None:
            raise RuntimeError("call enable_render_export() first")
        with span(STEP_EXPORT):
            return self._many_export(self._surface, params, frames, normals)

    @property
    def positions(self) -> np.ndarray:
        """[num_bodies, N, 3]."""
        return self.pos.cpu().numpy()

    def surface_mesh(self, normals: str = "smooth"):
        """Skinned surfaces of all bodies, concatenated: (verts [B*S,3],
        normals [B*S,3], tris [B*T,3], indices offset per body)."""
        if self._surface is None:
            raise ValueError("mesh has no embedded render surface")
        return self._surface.mesh_data(self.pos.reshape(-1, 3),
                                       self._flat_quats(), normals)

    def grab_particle(self, flat_pid: int, point) -> int:
        """Grab a known flat particle id (a viewer's raycast hit) in its
        body's slot; returns the body."""
        n = self.mesh.num_particles
        body = int(flat_pid) // n
        self.set_grab(body, int(flat_pid) - body * n, point)
        return body


def _build_grid_arrays(mesh, dims, engine, density, pinned, device):
    build = (build_nh_grid_arrays if engine.startswith("neohookean")
             else build_grid_arrays)
    return build(mesh, tuple(dims), density=density, pinned=pinned,
                 device=device)


class PackedGridBody:
    """A grid body whose state stays in the stencil kernels' layout across
    frames (``make_frame_stepper`` of ``kernels/polar_stencil.py`` or
    ``kernels/nh_stencil.py``): SimState is built only at the I/O boundary,
    positions cheaply.  The packed state carries the velocity, so a change
    of dt between steps needs no conversion.  Steps report no diagnostic
    (``last_diag`` None).  Grab API as ``Body``."""

    def __init__(self, mesh: TetMesh, arrays, params: PhysicsParams,
                 engine: str = "polar_grid_pallas"):
        if engine not in ("polar_grid_pallas", "neohookean_grid_pallas"):
            raise ValueError(
                "PackedGridBody runs the fused grid kernels "
                f"(polar_grid_pallas / neohookean_grid_pallas), not {engine!r}"
            )
        self.mesh = mesh
        self.arrays = arrays
        self.engine = engine
        self.device = arrays.device
        pack, self._stepfn, self._unpack, self._unpack_pos = \
            get_engine(engine).make_frame_stepper(arrays)
        self._pack = pack
        self._params = params
        self._packed = pack(init_state(mesh, self.device), params)
        self._packed0 = self._packed
        self.controls = Controls.none(self.device)
        self.last_diag = None
        self._surface = (_Surface(mesh, self.device)
                         if mesh.vis_tet_ids is not None else None)
        self._many_export = None

    def step(self, params: PhysicsParams):
        self._packed = self._stepfn(self._packed, params, self.controls)
        self._params = params
        self.last_diag = None

    def step_many(self, params: PhysicsParams, frames: int):
        for _ in range(frames):
            self.step(params)

    def enable_render_export(self, skin_ids, skin_w, tris):
        """Set up ``step_many_export`` with these skinning tables (device
        tensors, as ``_Surface`` holds them)."""
        def many(params, frames):
            self.step_many(params, frames)
            with span(EXPORT):
                with span(EXPORT_POSITIONS):
                    pos = self.pos_device()
                return _surface_render_data(pos, skin_ids, skin_w, tris)

        self._many_export = many

    def step_many_export(self, params: PhysicsParams, frames: int,
                         normals: str = "smooth"):
        """``frames`` frames, then the surface export [2,S,3] (device tensor,
        no sync).  The packed layout keeps the quaternions in kernel planes,
        so ``normals`` is accepted for Body's interface and the normals are
        always smooth, as in the JAX package."""
        del normals
        if self._many_export is None:
            raise RuntimeError(
                "call enable_render_export(skin_ids, skin_w, tris) first")
        with span(STEP_EXPORT):
            return self._many_export(params, frames)

    # -- state I/O boundary -------------------------------------------------
    @property
    def state(self) -> SimState:
        """The full SimState (a layout conversion)."""
        return self._unpack(self._packed, self._params)

    @state.setter
    def state(self, new: SimState):
        self._packed = self._pack(new, self._params)

    def pos_device(self) -> torch.Tensor:
        """Positions [N,3] on the device."""
        return self._unpack_pos(self._packed)

    @property
    def positions(self) -> np.ndarray:
        return self.pos_device().cpu().numpy()

    # -- interaction (as Body) ------------------------------------------------
    def start_grab(self, point) -> int:
        with span(GRAB_START):
            p = _point(point, self.device)
            gid = _nearest_particle(self.pos_device(), p)
            self.controls = Controls(grab_id=gid, grab_pos=p)
            return int(gid)

    def move_grabbed(self, point):
        with span(GRAB_MOVE):
            self.controls = self.controls.replace(
                grab_pos=_point(point, self.device))

    def end_grab(self):
        with span(GRAB_END):
            self.controls = Controls.none(self.device)

    def reset(self):
        self._packed = self._packed0
        self.end_grab()


class GridBodyBatch:
    """B grid boxes of one size stepped together, each with its own grab
    slot: one ``grid_frame`` call per frame with a leading body axis (the
    stencil kernels on CUDA, the plain engines on the CPU).  Engines
    ``polar_grid`` and ``neohookean_grid``; ``last_diag`` is their
    per-substep diagnostic [B, num_substeps].  The viewer contract of the
    JAX package: ``flat_mesh``, ``states``, ``positions`` [B, N, 3], per-body
    grabs and ``grab_particle``."""

    def __init__(
        self,
        dims,
        num_bodies: int,
        cell: float = 0.1,
        origins=None,
        engine: str = "polar_grid",
        density: float = 1000.0,
        with_edges: bool = False,
        with_surface: bool = False,
        device="cuda",
    ):
        if engine not in ("polar_grid", "neohookean_grid"):
            raise ValueError(
                "GridBodyBatch runs the stencil engines "
                f"(polar_grid / neohookean_grid), not {engine!r}"
            )
        self.engine = engine
        self.num_bodies = num_bodies
        self.dims = tuple(int(d) for d in dims)
        self.device = check_device(device)
        self.mesh = grid_mesh(*dims, cell=cell, origin=(0.0, 0.0, 0.0),
                              with_edges=with_edges)
        if with_surface:
            self.mesh = with_boundary_surface(self.mesh)
        self._n = self.mesh.num_particles
        self.arrays = _build_grid_arrays(self.mesh, dims, engine, density,
                                         None, self.device)
        self._kernel = get_engine(engine + "_pallas")  # the pair's kernels
        if origins is None:  # spread along x, one box width + one cell apart
            w = dims[0] * cell
            origins = np.stack([
                np.arange(num_bodies, dtype=np.float32) * np.float32(w + cell),
                np.full(num_bodies, 0.5, np.float32),
                np.zeros(num_bodies, np.float32)], axis=-1)
        origins = np.asarray(origins, np.float32).reshape(num_bodies, 3)
        verts = self.mesh.verts.astype(np.float32)[None] + origins[:, None]
        self.pos = planes(torch.as_tensor(verts).to(self.device))
        self.prev_pos = self.pos.clone()
        self.vel = torch.zeros_like(self.pos)
        self.quats = None
        if engine == "polar_grid":
            self.quats = torch.zeros(
                (num_bodies, 6, 4, self.arrays.num_tets // 6),
                dtype=torch.float32, device=self.device)
            self.quats[:, :, 3] = 1.0
        self.grab_id = torch.full((num_bodies, 1), -1, dtype=torch.int32,
                                  device=self.device)
        self.grab_pos = torch.zeros((num_bodies, 1, 3), dtype=torch.float32,
                                    device=self.device)
        self.last_diag: Optional[torch.Tensor] = None
        self.flat_mesh = replicate_mesh(self.mesh, num_bodies)
        self._surface = (_Surface(self.flat_mesh, self.device)
                         if with_surface else None)
        self._many_export = None

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every box by ``frames`` frames (no sync)."""
        for _ in range(frames):
            if self.quats is None:
                self.pos, self.prev_pos, self.vel, self.last_diag = \
                    self._kernel.grid_frame(self.pos, self.vel, self.arrays,
                                            params, self.grab_id,
                                            self.grab_pos, vol_err=True)
            else:
                self.pos, self.prev_pos, self.vel, self.quats = \
                    self._kernel.grid_frame(self.pos, self.vel, self.quats,
                                            self.arrays, params, self.grab_id,
                                            self.grab_pos)
                self.last_diag = self.pos.new_zeros(
                    (self.num_bodies, params.num_substeps))

    def enable_render_export(self):
        """Set up ``step_many_export`` for all boxes' boundary surfaces."""
        if self._surface is None:
            raise ValueError("batch was built without with_surface=True")
        self._many_export = _make_many_export(
            self.step, lambda: unplanes(self.pos).reshape(-1, 3),
            lambda: (None if self.quats is None
                     else quats_from_kernel(self.quats).reshape(-1, 4)))

    def step_many_export(self, params: PhysicsParams, frames: int,
                         normals: str = "smooth"):
        """``frames`` frames, then all boxes' surface export [2,B*S,3]
        (device tensor, no sync; see ``Body.step_many_export``)."""
        if self._many_export is None:
            raise RuntimeError("call enable_render_export() first")
        with span(STEP_EXPORT):
            vn = self._many_export(self._surface, params, frames, normals)
        self.last_diag = None
        return vn

    @property
    def states(self) -> SimState:
        """The boxes' SimState with a leading body axis."""
        if self.quats is None:
            quats = self.pos.new_zeros((self.num_bodies, self.arrays.num_tets, 4))
            quats[..., 3] = 1.0
        else:
            quats = quats_from_kernel(self.quats)
        return SimState(pos=unplanes(self.pos), prev_pos=unplanes(self.prev_pos),
                        vel=unplanes(self.vel), quats=quats)

    @property
    def positions(self) -> np.ndarray:
        """[num_bodies, N, 3]."""
        return unplanes(self.pos).cpu().numpy()

    def surface_mesh(self, normals: str = "smooth"):
        """Skinned boundary surfaces of all boxes, concatenated (built with
        ``with_surface=True``): (verts [B*S,3], normals [B*S,3], tris
        [B*T,3])."""
        if self._surface is None:
            raise ValueError("mesh has no embedded render surface")
        return self._surface.mesh_data(unplanes(self.pos).reshape(-1, 3),
                                       None, normals)

    def summary(self) -> dict:
        """Batch size, lowest particle, fastest particle and NaN flag, in
        one device-to-host transfer."""
        h = torch.stack([
            self.pos[:, 1].min(),
            torch.linalg.vector_norm(self.vel, dim=1).max(),
            torch.isnan(self.pos).any().to(torch.float32),
        ]).tolist()
        return {"batch": self.num_bodies, "min_height": h[0],
                "max_speed": h[1], "nan": bool(h[2])}

    # -- per-body interaction -----------------------------------------------
    def _check_body(self, body: int):
        if not 0 <= body < self.num_bodies:
            raise IndexError(
                f"body index {body} out of range (batch has {self.num_bodies})"
            )

    def set_grab(self, body: int, particle: int, point):
        with span(GRAB_START):
            self._check_body(body)
            self.grab_id[body, 0] = particle
            self.grab_pos[body, 0] = _point(point, self.device)

    def start_grab(self, body: int, point) -> int:
        """Grab the box's particle nearest to ``point``; returns its local
        id (the grid engines address particles per body)."""
        with span(GRAB_START):
            self._check_body(body)
            local = int(_nearest_particle(unplanes(self.pos[body]),
                                          _point(point, self.device)))
            self.set_grab(body, local, point)
            return local

    def grab_particle(self, flat_pid: int, point) -> int:
        """Grab a known flat particle id of ``flat_mesh``; returns the body."""
        body = int(flat_pid) // self._n
        self.set_grab(body, int(flat_pid) % self._n, point)
        return body

    def move_grabbed(self, body: int, point):
        with span(GRAB_MOVE):
            self._check_body(body)
            self.grab_pos[body, 0] = _point(point, self.device)

    def end_grab(self, body: int):
        with span(GRAB_END):
            self._check_body(body)
            self.grab_id[body, 0] = -1


class DenseBody:
    """B bodies of one mesh stepped by the dense Neo-Hookean engine
    (``solvers/dense.py``): bodies batched in columns, pos / prev_pos / vel
    [N, 3, B] (``state``), one launch of ``kernels/csrc/dense_frame.cu`` a
    frame on CUDA (each level gathered and scattered by index, at any
    number of particles; the one-hot products are the plain twin's, on the
    CPU, and the one-hot is built only when the twin runs).  ``coloring``
    "greedy" or "ordered" (the order-preserving levels of
    ``mesh.level_schedule``: the reference's exact order).  One grab per
    body: grab_id int32 [B] (-1 inactive), grab_pos [3, B].  The per-body
    grab API of the other batches; ``positions`` and ``velocities`` are [B,
    N, 3]."""

    def __init__(
        self,
        mesh: TetMesh,
        num_bodies: int,
        density: float = 1000.0,
        coloring: str = "greedy",
        jitter: float = 0.0,
        seed: int = 0,
        device="cuda",
    ):
        self.mesh = mesh
        self.engine = "dense"
        self.coloring = coloring
        self.num_bodies = num_bodies
        self.device = check_device(device)
        self.arrays = dense.build_dense_arrays(mesh, density, coloring,
                                               device=self.device)
        self.state = dense.init_dense_state(mesh, num_bodies, jitter, seed,
                                            device=self.device)
        self.grab_id = torch.full((num_bodies,), -1, dtype=torch.int32,
                                  device=self.device)
        self.grab_pos = torch.zeros((3, num_bodies), dtype=torch.float32,
                                    device=self.device)
        self.last_diag = None

    @property
    def state(self) -> dense.DenseState:
        return dense.DenseState(pos=self.pos, prev_pos=self.prev_pos,
                                vel=self.vel)

    @state.setter
    def state(self, s: dense.DenseState):
        self.pos, self.prev_pos, self.vel = s.pos, s.prev_pos, s.vel

    def step(self, params: PhysicsParams, frames: int = 1):
        """Advance every body by ``frames`` frames (no sync)."""
        for _ in range(frames):
            self.state = dense.step_frame(self.state, self.arrays, params,
                                          self.grab_id, self.grab_pos)

    # -- views ---------------------------------------------------------------
    def positions(self) -> np.ndarray:
        """[num_bodies, N, 3]."""
        return self.pos.movedim(-1, 0).cpu().numpy()

    def velocities(self) -> np.ndarray:
        return self.vel.movedim(-1, 0).cpu().numpy()

    def summary(self) -> dict:
        """Batch size, lowest particle, fastest particle and NaN flag, in
        one device-to-host transfer."""
        h = torch.stack([
            self.pos[:, 1].min(),
            torch.linalg.vector_norm(self.vel, dim=1).max(),
            torch.isnan(self.pos).any().to(torch.float32),
        ]).tolist()
        return {"batch": self.num_bodies, "min_height": h[0],
                "max_speed": h[1], "nan": bool(h[2])}

    # -- per-body interaction -----------------------------------------------
    def _check_body(self, body: int):
        if not 0 <= body < self.num_bodies:
            raise IndexError(
                f"body index {body} out of range (batch has {self.num_bodies})"
            )

    def set_grab(self, body: int, particle: int, point):
        with span(GRAB_START):
            self._check_body(body)
            self.grab_id[body] = particle
            self.grab_pos[:, body] = _point(point, self.device)

    def start_grab(self, body: int, point) -> int:
        """Grab the body's particle nearest to ``point``; returns its id."""
        with span(GRAB_START):
            self._check_body(body)
            pid = int(_nearest_particle(self.pos[..., body],
                                        _point(point, self.device)))
            self.set_grab(body, pid, point)
            return pid

    def move_grabbed(self, body: int, point):
        with span(GRAB_MOVE):
            self._check_body(body)
            self.grab_pos[:, body] = _point(point, self.device)

    def end_grab(self, body: int):
        with span(GRAB_END):
            self._check_body(body)
            self.grab_id[body] = -1


# the batches: step(params, frames) advances them, summary() reports them
BATCHES = (FusedBatch, GridBodyBatch, DenseBody)


class World:
    """Scene container + frame loop on one device ("cuda" or "cpu")."""

    def __init__(self, params: Optional[PhysicsParams] = None, device="cuda"):
        self.params = params if params is not None else PhysicsParams()
        self.device = check_device(device)
        self.bodies: list = []
        # construction specs recorded by the add_* calls, so that a scene
        # checkpoint rebuilds the world from one file; None marks a body
        # that load cannot rebuild (prebuilt arrays)
        self._specs: list = []

    @staticmethod
    def _pins(pinned):
        return None if pinned is None else np.asarray(pinned).tolist()

    def add_body(
        self,
        mesh: TetMesh,
        engine: str = "neohookean",
        coloring: Optional[str] = "auto",
        density: Optional[float] = None,
        arrays: Optional[TetArrays] = None,
        pinned=None,
    ) -> Body:
        d = float(self.params.density) if density is None else density
        body = Body(mesh, engine=engine, coloring=coloring, density=d,
                    arrays=arrays, pinned=pinned, device=self.device)
        self.bodies.append(body)
        self._specs.append(None if arrays is not None else {
            "add": "body", "engine": engine, "coloring": coloring,
            "density": d, "pinned": self._pins(pinned), "_mesh": mesh,
        })
        return body

    def add_grid_body(
        self,
        dims,
        cell: float = 0.1,
        origin=(0.0, 0.0, 0.0),
        density: Optional[float] = None,
        pinned=None,
        with_edges: bool = False,
        engine: str = "polar_grid",
        packed: bool = False,
        with_surface: bool = False,
    ):
        """Add a ``grid_mesh`` box stepped by a stencil engine: ``Body`` with
        grid arrays, or with ``packed=True`` (the ``*_pallas`` engines) a
        ``PackedGridBody``, whose state stays in the kernels' layout across
        frames.  ``with_surface`` gives the box its boundary triangles as a
        render surface."""
        if engine not in GRID_ENGINES:
            raise ValueError(
                f"add_grid_body runs the stencil engines, not {engine!r}")
        if packed and not engine.endswith("_pallas"):
            raise ValueError(
                "packed grid state requires a fused kernel engine "
                "(polar_grid_pallas / neohookean_grid_pallas)")
        d = float(self.params.density) if density is None else density
        mesh = grid_mesh(*dims, cell=cell, origin=origin, with_edges=with_edges)
        if with_surface:
            mesh = with_boundary_surface(mesh)
        arrays = _build_grid_arrays(mesh, dims, engine, d, pinned, self.device)
        if packed:
            body = PackedGridBody(mesh, arrays, self.params, engine=engine)
        else:
            body = Body(mesh, engine=engine, arrays=arrays, coloring=None,
                        device=self.device)
        self.bodies.append(body)
        self._specs.append({
            "add": "grid_body", "dims": [int(x) for x in dims],
            "cell": float(cell), "origin": [float(x) for x in origin],
            "density": d, "pinned": self._pins(pinned),
            "with_edges": with_edges, "engine": engine, "packed": packed,
            "with_surface": with_surface,
        })
        return body

    def add_grid_body_batch(
        self,
        dims,
        num_bodies: int,
        cell: float = 0.1,
        origins=None,
        engine: str = "polar_grid",
        density: Optional[float] = None,
        with_edges: bool = False,
        with_surface: bool = False,
    ) -> GridBodyBatch:
        """Add B grid boxes stepped together, each with its own grab."""
        d = float(self.params.density) if density is None else density
        batch = GridBodyBatch(dims, num_bodies, cell=cell, origins=origins,
                              engine=engine, density=d, with_edges=with_edges,
                              with_surface=with_surface, device=self.device)
        self.bodies.append(batch)
        self._specs.append({
            "add": "grid_body_batch", "dims": [int(x) for x in dims],
            "num_bodies": num_bodies, "cell": float(cell),
            "origins": None if origins is None
            else np.asarray(origins, np.float32).tolist(),
            "engine": engine, "density": d, "with_edges": with_edges,
            "with_surface": with_surface,
            "color_scan": False,  # the JAX package's flag; no effect here
        })
        return batch

    def add_body_batch(
        self,
        mesh: TetMesh,
        num_bodies: int,
        engine: str = "polar",
        backend: str = "flat",
        jitter: float = 0.0,
        seed: int = 0,
        density: Optional[float] = None,
    ):
        """Add a batch of bodies of one mesh, each with its own grab.

        backend="flat"  — ``BatchedBody``, one flattened disjoint mesh
                          (polar or neohookean, the latter on the ordered
                          schedule);
        backend="fused" — ``FusedGSBody`` (neohookean) or ``FusedPolarBody``
                          (polar): one fused-kernel launch per frame;
        backend="fused_ordered" — ``OrderedGSBody``: the neohookean engine in
                          the reference's exact constraint order, exactly 8
                          bodies, one launch of the exact-order kernel per
                          frame;
        backend="dense" — ``DenseBody``: the neohookean engine with bodies
                          batched in columns, one launch of the dense
                          frame kernel per frame (each level gathered and
                          scattered by index), on the greedy colouring;
        backend="dense_ordered" — ``DenseBody`` on the order-preserving
                          levels: the dense engine in the reference's exact
                          constraint order, any number of bodies.
        """
        d = float(self.params.density) if density is None else density
        kw = dict(density=d, jitter=jitter, seed=seed, device=self.device)
        if backend == "fused_ordered":
            if engine != "neohookean":
                raise ValueError(
                    "the fused_ordered backend implements the neohookean "
                    f"engine, not {engine!r}"
                )
            if num_bodies != 8:
                raise ValueError(
                    "the fused_ordered kernel batches exactly 8 bodies "
                    f"(sublane-fixed), got num_bodies={num_bodies}"
                )
            batch = OrderedGSBody(mesh, **kw)
        elif backend == "fused":
            if engine == "neohookean":
                batch = FusedGSBody(mesh, num_bodies, **kw)
            elif engine == "polar":
                batch = FusedPolarBody(mesh, num_bodies, **kw)
            else:
                raise ValueError(
                    "the fused backend implements the neohookean and polar "
                    f"engines, not {engine!r}"
                )
        elif backend in ("dense", "dense_ordered"):
            if engine != "neohookean":
                raise ValueError(
                    f"the {backend} backend implements the neohookean engine")
            coloring = "ordered" if backend == "dense_ordered" else "greedy"
            batch = DenseBody(mesh, num_bodies, coloring=coloring, **kw)
        elif backend == "flat":
            batch = BatchedBody(mesh, num_bodies, engine=engine, **kw)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.bodies.append(batch)
        self._specs.append({
            "add": "body_batch", "num_bodies": num_bodies, "engine": engine,
            "backend": backend, "jitter": float(jitter), "seed": int(seed),
            "density": d, "_mesh": mesh,
        })
        return batch

    # -- scene checkpoint ------------------------------------------------------
    def save(self, path: str) -> None:
        """One-file scene checkpoint: the params, every body's state (the
        fused batches' planes, a packed grid body's state) and the
        construction specs, in the JAX package's format."""
        from . import checkpoint

        checkpoint.save_world(self, path)

    def restore(self, path: str) -> None:
        """Restore a scene checkpoint into this world, which must hold the
        same bodies (types, engines and meshes are checked)."""
        from . import checkpoint

        checkpoint.restore_world(self, path)

    @staticmethod
    def load(path: str, device="cuda") -> "World":
        """Rebuild a whole World on ``device`` from a scene checkpoint."""
        from . import checkpoint

        return checkpoint.load_world(path, device=device)

    def step(self, frames: int = 1):
        """Advance all bodies by ``frames`` frames (bodies are independent,
        so each runs its frames in turn)."""
        with span(WORLD_STEP):
            for body in self.bodies:
                if isinstance(body, BATCHES):
                    body.step(self.params, frames)
                else:
                    body.step_many(self.params, frames)

    def diagnostics(self) -> dict:
        """Per body, as Python numbers: a batch (``FusedGSBody``,
        ``FusedPolarBody``, ``OrderedGSBody``, ``BatchedBody``,
        ``GridBodyBatch``, ``DenseBody``) its size, lowest particle, fastest particle and
        NaN flag; any other body ``diag.summarize``."""
        out = {}
        for i, b in enumerate(self.bodies):
            if isinstance(b, BATCHES):
                out[f"body{i}"] = b.summary()
            else:
                out[f"body{i}"] = diag.summarize(b.state, b.arrays, b.last_diag)
        return out
