"""Scene API (counterpart of ``tetsim_tpu/world.py``): bodies are added to
a ``World`` on one device, ``world.step(frames)`` advances every body, and
render data (skinned surface vertices, normals) is computed on the device
and brought to the host on demand.

Stepping never waits for the device: ``positions``, ``surface_mesh``,
``diagnostics`` and ``start_grab`` (which returns the grabbed id) are the
calls that synchronise.  This package carries the Neo-Hookean engine only:
``Body`` runs it through ``solvers/neohookean.py`` (one fused-kernel launch
per frame on CUDA) and ``add_body_batch`` through ``FusedGSBody``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import diag
from .kernels import gs_fused
from .kernels.gs_fused import FusedGSBody
from .mesh import TetArrays, TetMesh, build_arrays
from .params import PhysicsParams
from .solvers import get_engine
from .state import Controls, init_state
from .utils import mat3


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tetsim_torch runs on cpu or cuda, not {dev}")
    return dev


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


class _Surface:
    """Embedded-surface render tables + skinning for one mesh."""

    def __init__(self, mesh: TetMesh, device):
        self.skin_ids = torch.as_tensor(
            mesh.tets[mesh.vis_tet_ids].astype(np.int64)).to(device)  # [S,4]
        b = mesh.vis_bary
        w = np.concatenate([b, 1.0 - b.sum(axis=1, keepdims=True)], axis=1)
        self.skin_w = torch.as_tensor(w.astype(np.float32)).to(device)  # [S,4]
        self.tris_np = np.asarray(mesh.tris, np.int32)
        self.tris = torch.as_tensor(self.tris_np.astype(np.int64)).to(device)

    def positions(self, pos) -> np.ndarray:
        return _skin_surface(pos, self.skin_ids, self.skin_w).cpu().numpy()

    def mesh_data(self, pos, normals: str = "smooth"):
        """(verts [S,3], normals [S,3], tris [T,3]) as numpy, one transfer."""
        if normals != "smooth":
            raise ValueError(
                f"normals={normals!r}: only 'smooth' is ported (rotated "
                "normals need the polar engine, see ROADMAP.md)"
            )
        verts = _skin_surface(pos, self.skin_ids, self.skin_w)
        vn = torch.stack([verts, _vertex_normals(verts, self.tris)]).cpu().numpy()
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
        device="cpu",
    ):
        self.engine_mod = get_engine(engine)
        self.mesh = mesh
        self.engine = engine
        self.device = _device(device)
        if coloring == "auto":
            coloring = "ordered"
        if arrays is not None and pinned is not None:
            raise ValueError(
                "pinned= has no effect when arrays= is prebuilt — bake the "
                "pins in (build_arrays takes pinned=)"
            )
        if self.device.type == "cuda":
            gs_fused.check_fits(mesh.num_particles)
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
        computed on the device and brought over in one transfer."""
        return self._need_surface().mesh_data(self.state.pos, normals)


class World:
    """Scene container + frame loop on one device ("cpu" or "cuda")."""

    def __init__(self, params: Optional[PhysicsParams] = None, device="cpu"):
        self.params = params if params is not None else PhysicsParams()
        self.device = _device(device)
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
        engine: str = "neohookean",
        backend: str = "fused",
        jitter: float = 0.0,
        seed: int = 0,
        density: Optional[float] = None,
    ) -> FusedGSBody:
        """A batch of bodies of one mesh, one fused-kernel launch per frame
        (``backend="fused"``, ``engine="neohookean"``: the only pair ported)."""
        if engine != "neohookean" or backend != "fused":
            raise ValueError(
                f"add_body_batch(engine={engine!r}, backend={backend!r}): only "
                "engine='neohookean' with backend='fused' is ported (see "
                "ROADMAP.md)"
            )
        d = float(self.params.density) if density is None else density
        batch = FusedGSBody(mesh, num_bodies, density=d, jitter=jitter,
                            seed=seed, device=self.device)
        self.bodies.append(batch)
        return batch

    def step(self, frames: int = 1):
        """Advance all bodies by ``frames`` frames (bodies are independent,
        so each runs its frames in turn)."""
        for body in self.bodies:
            if isinstance(body, FusedGSBody):
                body.step(self.params, frames)
            else:
                body.step_many(self.params, frames)

    def diagnostics(self) -> dict:
        out = {}
        for i, b in enumerate(self.bodies):
            if isinstance(b, FusedGSBody):
                h = torch.stack([
                    b.pos[..., 1].min(),
                    torch.linalg.vector_norm(b.vel, dim=-1).max(),
                    torch.isnan(b.pos).any().to(torch.float32),
                ]).tolist()
                out[f"body{i}"] = {
                    "batch": b.num_bodies, "min_height": h[0],
                    "max_speed": h[1], "nan": bool(h[2]),
                }
            else:
                out[f"body{i}"] = diag.summarize(b.state, b.arrays, b.last_diag)
        return out
