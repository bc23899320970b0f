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
per frame on CUDA), ``add_body_batch`` runs ``FusedGSBody``,
``FusedPolarBody`` or the polar ``BatchedBody``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import diag
from .kernels import gs_fused, polar_fused
from .kernels.batch import FusedBatch
from .kernels.gs_fused import FusedGSBody
from .kernels.polar_fused import FusedPolarBody
from .mesh import TetArrays, TetMesh, build_arrays, replicate_mesh
from .params import PhysicsParams
from .solvers import get_engine
from .solvers.polar import quat_rotate
from .state import Controls, check_device, init_state
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
        verts = _skin_surface(pos, self.skin_ids, self.skin_w)
        if normals == "smooth":
            nrm = _vertex_normals(verts, self.tris)
        elif normals == "rotated":
            if quats is None:
                raise ValueError(
                    "rotated normals need per-tet quaternions (polar engine)")
            nrm = _rotated_normals(self.rest_normals, quats, self.vis_tet_ids)
        else:
            raise ValueError(f"unknown normals mode {normals!r}")
        vn = torch.stack([verts, nrm]).cpu().numpy()
        return vn[0], vn[1], self.tris_np


class Body:
    """One soft body: mesh constants + simulation state + interaction."""

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
        if arrays is not None and pinned is not None:
            raise ValueError(
                "pinned= has no effect when arrays= is prebuilt — bake the "
                "pins in (build_arrays takes pinned=)"
            )
        if self.device.type == "cuda":
            kernel = polar_fused if engine == "polar" else gs_fused
            kernel.check_fits(mesh.num_particles)
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

    # -- stepping ---------------------------------------------------------
    def step(self, params: PhysicsParams):
        """One frame; returns its vol_errs [num_substeps] (device tensor)."""
        self.state, self.last_diag = self.engine_mod.step_frame(
            self.state, self.arrays, params, self.controls
        )
        return self.last_diag

    def step_many(self, params: PhysicsParams, frames: int):
        """``frames`` frames; diagnostics carry the last frame's."""
        for _ in range(frames):
            self.step(params)
        return self.last_diag

    # -- interaction --------------------------------------------------------
    def start_grab(self, point) -> int:
        """Grab the particle nearest to ``point``; returns its id."""
        p = _point(point, self.device)
        gid = _nearest_particle(self.state.pos, p)
        self.controls = Controls(grab_id=gid, grab_pos=p)
        return int(gid)

    def move_grabbed(self, point):
        self.controls = self.controls.replace(grab_pos=_point(point, self.device))

    def end_grab(self):
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


class BatchedBody(FusedPolarBody):
    """N bodies of one mesh as one flattened disjoint mesh, body-major
    (``replicate_mesh``): flat particle ``b * N + i`` is particle i of body
    b, and the surface of all bodies is one concatenated mesh.  Each body
    has one grab slot; ``positions`` is a property, as in the JAX package.

    Only the polar engine is ported.  Its bodies step through the fused
    polar frame kernel as a [B, N] batch, one block per body, with the
    single mesh's tables: the flat mesh is disjoint and body-major, so that
    gives the numbers the flat mesh would (a particle's incident corners
    keep their order), and a flat mesh of 8 dragons (9,872 particles, 355 KB
    of particle planes) would not fit one block's shared memory.  So this is
    a ``FusedPolarBody`` with the flat layout's surface and grab by flat
    particle id."""

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
        if engine != "polar":
            raise ValueError(
                f"BatchedBody(engine={engine!r}): only the polar engine is "
                "ported for flat batches (see ROADMAP.md); use "
                "backend='fused' for neohookean"
            )
        super().__init__(mesh, num_bodies, density=density, jitter=jitter,
                         seed=seed, device=device)
        self.engine = engine
        self.flat_mesh = replicate_mesh(mesh, num_bodies, jitter=jitter, seed=seed)
        self._surface = (
            _Surface(self.flat_mesh, self.device)
            if self.flat_mesh.vis_tet_ids is not None else None
        )

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
                                       self.quats.reshape(-1, 4), normals)

    def grab_particle(self, flat_pid: int, point) -> int:
        """Grab a known flat particle id (a viewer's raycast hit) in its
        body's slot; returns the body."""
        n = self.mesh.num_particles
        body = int(flat_pid) // n
        self.set_grab(body, int(flat_pid) - body * n, point)
        return body


class World:
    """Scene container + frame loop on one device ("cuda" or "cpu")."""

    def __init__(self, params: Optional[PhysicsParams] = None, device="cuda"):
        self.params = params if params is not None else PhysicsParams()
        self.device = check_device(device)
        self.bodies: list = []

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
        return body

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

        backend="flat"  — ``BatchedBody``, one flattened disjoint mesh (the
                          polar engine; neohookean is not ported here);
        backend="fused" — ``FusedGSBody`` (neohookean) or ``FusedPolarBody``
                          (polar): one fused-kernel launch per frame.
        """
        d = float(self.params.density) if density is None else density
        kw = dict(density=d, jitter=jitter, seed=seed, device=self.device)
        if backend == "fused":
            if engine == "neohookean":
                batch = FusedGSBody(mesh, num_bodies, **kw)
            elif engine == "polar":
                batch = FusedPolarBody(mesh, num_bodies, **kw)
            else:
                raise ValueError(
                    "the fused backend implements the neohookean and polar "
                    f"engines, not {engine!r}"
                )
        elif backend == "flat":
            batch = BatchedBody(mesh, num_bodies, engine=engine, **kw)
        else:
            raise ValueError(
                f"backend {backend!r} is not ported (see ROADMAP.md); the "
                "port has 'flat' and 'fused'"
            )
        self.bodies.append(batch)
        return batch

    def step(self, frames: int = 1):
        """Advance all bodies by ``frames`` frames (bodies are independent,
        so each runs its frames in turn)."""
        for body in self.bodies:
            if isinstance(body, FusedBatch):
                body.step(self.params, frames)
            else:
                body.step_many(self.params, frames)

    def diagnostics(self) -> dict:
        out = {}
        for i, b in enumerate(self.bodies):
            if isinstance(b, FusedBatch):
                out[f"body{i}"] = b.summary()
            else:
                out[f"body{i}"] = diag.summarize(b.state, b.arrays, b.last_diag)
        return out
