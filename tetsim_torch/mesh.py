"""Tetrahedral mesh types, rest-state precompute and constraint colouring.

Counterpart of ``tetsim_tpu/mesh.py``.  The host side is the same numpy
code, so the integer schedule tables and the f32 rest constants equal the
reference's exactly; ``TetArrays`` is a dataclass of torch tensors.

  verts  float32[N,3]   rest positions
  tets   int32[M,4]     connectivity
  vis_*                 embedded render surface (barycentric skinning)

Per-tet constants: inv_rest_pose [M,3,3] (D^-1, columns of D are the rest
edge vectors), inv_rest_volume [M], rest_volume [M], inv_mass [N] (lumped,
each tet adds V/4*density to its corners), rest_centered [M,4,3].

Colourings: ``level_schedule`` keeps the sequential Gauss-Seidel order
(exact reference trajectory), ``greedy_color`` uses fewer colours.  Within
a colour the tets share no vertex, so a whole level is solved at once.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import torch

from . import native
from ._compile import TPU_PKG_DIR


@dataclasses.dataclass(frozen=True)
class TetMesh:
    """Host-side (numpy) tetrahedral mesh with optional render surface."""

    verts: np.ndarray  # float32 [N,3]
    tets: np.ndarray  # int32 [M,4]
    edges: Optional[np.ndarray] = None  # int32 [E,2]
    vis_tet_ids: Optional[np.ndarray] = None  # int32 [S]
    vis_bary: Optional[np.ndarray] = None  # float32 [S,3] (b3 = 1-b0-b1-b2)
    tris: Optional[np.ndarray] = None  # int32 [T,3]

    @property
    def num_particles(self) -> int:
        return self.verts.shape[0]

    @property
    def num_tets(self) -> int:
        return self.tets.shape[0]

    @property
    def num_surface_verts(self) -> int:
        return 0 if self.vis_tet_ids is None else self.vis_tet_ids.shape[0]


def load_dragon() -> TetMesh:
    """The reference's dragon (1,234 particles / 3,840 tets / 29,800
    surface verts), read from the JAX package's asset by path."""
    with np.load(os.path.join(TPU_PKG_DIR, "assets", "dragon.npz")) as z:
        return TetMesh(
            verts=z["verts"],
            tets=z["tet_ids"],
            edges=z["edge_ids"],
            vis_tet_ids=z["vis_tet_ids"],
            vis_bary=z["vis_bary"],
            tris=z["tri_ids"],
        )


def rest_state(mesh: TetMesh, density: float = 1000.0, dtype=np.float32,
               pinned=None):
    """Returns (inv_rest_pose[M,3,3], inv_rest_volume[M], rest_volume[M],
    inv_mass[N], rest_centered[M,4,3]) as numpy arrays.

    Degenerate tets get a zero inv_rest_pose; pinned particles get
    inv_mass 0 and never move."""
    verts = mesh.verts.astype(dtype)
    tets = mesh.tets
    p = verts[tets]  # [M,4,3]
    d = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1)
    det = np.linalg.det(d.astype(np.float64))
    vol = (det / 6.0).astype(dtype)

    inv_rest_pose = np.zeros_like(d)
    ok = det != 0.0
    inv_rest_pose[ok] = np.linalg.inv(d[ok].astype(np.float64)).astype(dtype)

    with np.errstate(divide="ignore"):
        inv_rest_volume = np.where(vol != 0.0, 1.0 / vol, 0.0).astype(dtype)

    mass = np.zeros(mesh.num_particles, dtype)
    pm = vol / 4.0 * dtype(density)
    for c in range(4):
        np.add.at(mass, tets[:, c], pm)
    with np.errstate(divide="ignore"):
        inv_mass = np.where(mass != 0.0, 1.0 / mass, 0.0).astype(dtype)
    if pinned is not None:
        inv_mass[np.asarray(pinned, np.int64)] = 0.0

    # centroid with the runtime add order of the polar solve
    centroid = (((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]) * dtype(0.25)
    rest_centered = (p - centroid[:, None, :]).astype(dtype)
    return inv_rest_pose, inv_rest_volume, vol, inv_mass, rest_centered


def level_schedule(tets: np.ndarray, num_particles: int) -> np.ndarray:
    """Order-preserving levels: ``level[i] = 1 + max(level[j])`` over earlier
    tets j sharing a vertex with i.  Returns int32[M]."""
    out = native.level_schedule(tets, num_particles)
    if out is not None:
        return out
    vert_level = np.full(num_particles, -1, np.int64)
    levels = np.empty(tets.shape[0], np.int32)
    for i, tet in enumerate(tets):
        lvl = vert_level[tet].max() + 1
        levels[i] = lvl
        vert_level[tet] = np.maximum(vert_level[tet], lvl)
    return levels


def greedy_color(tets: np.ndarray, num_particles: int) -> np.ndarray:
    """First-fit greedy colouring of the tet conflict graph.  Returns
    int32[M]; fewer colours than the level schedule, another GS order."""
    out = native.greedy_color(tets, num_particles)
    if out is not None:
        return out
    colors = np.full(tets.shape[0], -1, np.int32)
    vert_used = [0] * num_particles  # per-vertex bitmask of used colours
    for i, tet in enumerate(tets):
        used = 0
        for v in tet:
            used |= vert_used[v]
        c = 0
        while used >> c & 1:
            c += 1
        colors[i] = c
        for v in tet:
            vert_used[v] |= 1 << c
    return colors


def color_slots(colors: np.ndarray) -> np.ndarray:
    """Pack per-tet colours into a dense schedule int32[L, Cmax]: row c lists
    the tets of colour c in ascending order, padded with -1."""
    out = native.color_slots(colors)
    if out is not None:
        return out
    num_colors = int(colors.max()) + 1
    counts = np.bincount(colors, minlength=num_colors)
    slots = np.full((num_colors, int(counts.max())), -1, np.int32)
    fill = np.zeros(num_colors, np.int64)
    for i, c in enumerate(colors):
        slots[c, fill[c]] = i
        fill[c] += 1
    return slots


@dataclasses.dataclass
class TetArrays:
    """Per-mesh constants of the solvers, as tensors on one device.

    The colored Gauss-Seidel schedule is slot-major: per-level, per-slot
    copies of every per-tet constant (``slot_*``, [L,C,...]) gathered on the
    host, so the level loop reads tables in order and gathers only
    particles.  Padded slots have ``slot_valid`` False and ``slot_tets`` 0.
    The slot fields are None when no schedule was built.

    The polar engine's incidence tables list, per particle, its corner ids
    ``tet*4 + k`` in ascending order (``inc_idx``, -1 padded to the largest
    valence K) and the sum of its tets' rest volumes (``inc_den``); they
    are None when not built."""

    tets: torch.Tensor  # int32 [M,4]
    inv_rest_pose: torch.Tensor  # f32 [M,3,3]
    inv_rest_volume: torch.Tensor  # f32 [M]
    rest_volume: torch.Tensor  # f32 [M]
    inv_mass: torch.Tensor  # f32 [N]
    rest_centered: torch.Tensor  # f32 [M,4,3]
    slot_tets: Optional[torch.Tensor] = None  # int32 [L,C,4]
    slot_inv_rest_pose: Optional[torch.Tensor] = None  # f32 [L,C,3,3]
    slot_inv_rest_volume: Optional[torch.Tensor] = None  # f32 [L,C]
    slot_valid: Optional[torch.Tensor] = None  # bool [L,C]
    slot_inv: Optional[torch.Tensor] = None  # int32 [L,N] particle->4*slot+corner
    slot_inv_mass: Optional[torch.Tensor] = None  # f32 [L,C,4]
    # -- polar scatter-as-gather tables (None when not built) --
    inc_idx: Optional[torch.Tensor] = None  # int32 [N,K] corner ids, -1 pad
    inc_den: Optional[torch.Tensor] = None  # f32 [N] sum of incident rest volumes

    @property
    def num_particles(self) -> int:
        return self.inv_mass.shape[-1]

    @property
    def num_tets(self) -> int:
        return self.tets.shape[-2]

    def to(self, device) -> "TetArrays":
        return TetArrays(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def build_schedule(colors: np.ndarray, tets, inv_rest_pose, inv_rest_volume,
                   num_particles: int, inv_mass=None):
    """Pre-gather per-tet constants into slot-major [L,Cmax,...] arrays, and
    the per-level inverse index ``slot_inv [L,N]`` (particle -> slot*4 +
    corner, or -1), which turns the level's write-back into a gather."""
    slots = color_slots(colors)  # [L,C], -1 padded
    valid = slots >= 0
    e = np.where(valid, slots, 0)
    slot_tets = tets[e].astype(np.int32)
    slot_tets[~valid] = 0
    slot_irp = inv_rest_pose[e]
    slot_irp[~valid] = 0.0
    slot_irv = inv_rest_volume[e]
    slot_irv[~valid] = 0.0

    L = slots.shape[0]
    slot_inv = np.full((L, num_particles), -1, np.int32)
    for l in range(L):
        t_idx = np.nonzero(valid[l])[0]
        corners = slot_tets[l, t_idx]  # [k,4]
        for c in range(4):
            slot_inv[l, corners[:, c]] = t_idx * 4 + c
    slot_imc = None
    if inv_mass is not None:
        slot_imc = inv_mass[slot_tets].astype(np.float32)  # [L,C,4]
        slot_imc[~valid] = 0.0
    return slot_tets, slot_irp, slot_irv, valid, slot_inv, slot_imc


def build_arrays(
    mesh: TetMesh,
    density: float = 1000.0,
    coloring: Optional[str] = "ordered",
    incidence: Optional[bool] = None,
    pinned=None,
    *,
    device,
) -> TetArrays:
    """Precompute everything the solvers need, as tensors on ``device``.

    coloring: "ordered" (level schedule, the reference's exact GS order),
    "greedy" (fewest colours) or None (no GS schedule; the polar engine).
    incidence: build the polar engine's ``inc_idx``/``inc_den``; by default
    only when no GS schedule is asked for."""
    ir, irv, vol, im, rc = rest_state(mesh, density, pinned=pinned)
    sched = (None,) * 6
    if coloring == "ordered":
        colors = level_schedule(mesh.tets, mesh.num_particles)
    elif coloring == "greedy":
        colors = greedy_color(mesh.tets, mesh.num_particles)
    elif coloring is not None:
        raise ValueError(f"unknown coloring {coloring!r}")
    if coloring is not None:
        sched = build_schedule(colors, mesh.tets, ir, irv, mesh.num_particles, im)
    st, sp, sv, sd, si, sm = sched
    if incidence is None:
        incidence = coloring is None
    inc_idx = inc_den = None
    if incidence:
        inc_idx, inc_den = build_incidence(mesh.tets, vol, mesh.num_particles)

    def t(x):
        return None if x is None else torch.as_tensor(x).to(device)

    return TetArrays(
        tets=t(mesh.tets.astype(np.int32)),
        inv_rest_pose=t(ir), inv_rest_volume=t(irv), rest_volume=t(vol),
        inv_mass=t(im), rest_centered=t(rc),
        slot_tets=t(st), slot_inv_rest_pose=t(sp), slot_inv_rest_volume=t(sv),
        slot_valid=t(sd), slot_inv=t(si), slot_inv_mass=t(sm),
        inc_idx=t(inc_idx), inc_den=t(inc_den),
    )


def build_incidence(tets: np.ndarray, rest_volume: np.ndarray,
                    num_particles: int):
    """Particle -> incident corner table, the scatter of the polar solve
    turned into a gather.  Returns (inc_idx int32 [N,K], inc_den f32 [N]):
    the corner ids ``tet*4 + k`` of each particle in ascending order, -1
    padded to the largest valence K, and the sum of its tets' rest volumes
    (added in f64, rounded once)."""
    seg = tets.reshape(-1).astype(np.int64)  # corner id -> particle
    order = np.argsort(seg, kind="stable").astype(np.int32)
    counts = np.bincount(seg, minlength=num_particles)
    k = int(counts.max()) if len(seg) else 0
    inc = np.full((num_particles, k), -1, np.int32)
    starts = np.cumsum(counts) - counts
    pos_sorted = np.arange(len(seg), dtype=np.int64) - np.repeat(starts, counts)
    inc[seg[order], pos_sorted] = order
    den = np.zeros(num_particles, np.float64)
    np.add.at(den, seg, np.repeat(rest_volume.astype(np.float64), 4))
    return inc, den.astype(np.float32)


def replicate_mesh(mesh: TetMesh, n: int, jitter: float = 0.0,
                   seed: int = 0) -> TetMesh:
    """n copies of a mesh as one disjoint mesh, body-major: copy b's
    particle, tet and surface ids are offset by b times the mesh's counts.
    ``jitter`` offsets each copy by a seeded random translation (y kept
    non-negative), drawn as ``FusedPolarBody`` and ``FusedGSBody`` draw
    theirs."""
    nv, nt = mesh.num_particles, mesh.num_tets
    off = np.zeros((n, 1, 3), np.float32)
    if jitter:
        rng = np.random.RandomState(seed)
        off = rng.uniform(-jitter, jitter, (n, 1, 3)).astype(np.float32)
        off[:, :, 1] = np.abs(off[:, :, 1])  # keep above ground
    verts = (mesh.verts[None] + off).reshape(-1, 3)

    def rep_idx(x, stride):
        if x is None:
            return None
        shift = np.arange(n, dtype=np.int64).reshape((n,) + (1,) * x.ndim)
        return (x[None] + shift * stride).reshape(
            (-1,) + x.shape[1:]).astype(np.int32)

    return TetMesh(
        verts=verts,
        tets=rep_idx(mesh.tets, nv),
        edges=rep_idx(mesh.edges, nv),
        vis_tet_ids=rep_idx(mesh.vis_tet_ids, nt),
        vis_bary=None if mesh.vis_bary is None else np.tile(mesh.vis_bary, (n, 1)),
        tris=rep_idx(mesh.tris, mesh.num_surface_verts),
    )


def grid_mesh(nx: int, ny: int, nz: int, cell: float = 0.1,
              origin=(0.0, 0.0, 0.0), with_edges: bool = False) -> TetMesh:
    """Axis-aligned block of nx*ny*nz cubes, each Kuhn-split into 6 tets
    (conforming across cube faces)."""
    gx, gy, gz = nx + 1, ny + 1, nz + 1
    xs = origin[0] + np.arange(gx) * cell
    ys = origin[1] + np.arange(gy) * cell
    zs = origin[2] + np.arange(gz) * cell
    vx, vy, vz = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([vx, vy, vz], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j, k):
        return (i * gy + j) * gz + k

    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    # Kuhn subdivision: one tet per axis permutation (monotone path 000->111)
    tet_list = []
    for perm in itertools.permutations(range(3)):
        steps = np.zeros((4, 3), np.int64)
        for s, axis in enumerate(perm):
            steps[s + 1] = steps[s]
            steps[s + 1, axis] += 1
        corners = [vid(ci + d[0], cj + d[1], ck + d[2]) for d in steps]
        tet_list.append(np.stack(corners, axis=-1))
    tets = np.concatenate(tet_list, axis=0).astype(np.int32)

    # positive orientation (det of edge matrix > 0)
    p = verts[tets]
    d = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1)
    neg = np.linalg.det(d) < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    edges = _derive_edges(tets) if with_edges else None
    return TetMesh(verts=verts, tets=tets, edges=edges)


def _derive_edges(tets: np.ndarray) -> np.ndarray:
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    return np.unique(
        np.sort(np.concatenate([tets[:, list(c)] for c in pairs], axis=0), axis=1),
        axis=0,
    ).astype(np.int32)


def masked_grid_mesh(nx: int, ny: int, nz: int, keep, cell: float = 0.1,
                     origin=(0.0, 0.0, 0.0), with_edges: bool = False) -> TetMesh:
    """``grid_mesh`` with its cubes filtered by ``keep(centers f32 [C,3]) ->
    bool [C]`` over the cube centres, unused vertices compacted: a shaped,
    irregular body (no stencil engine applies; the pieces engines do)."""
    full = grid_mesh(nx, ny, nz, cell=cell, origin=origin)
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    centers = (
        np.asarray(origin, np.float32)
        + (np.stack([ci, cj, ck], axis=-1).reshape(-1, 3) + 0.5)
        * np.float32(cell)
    ).astype(np.float32)
    mask = np.asarray(keep(centers), bool)
    if mask.shape != (nx * ny * nz,):
        raise ValueError(f"keep() must return bool [{nx*ny*nz}], got {mask.shape}")
    if not mask.any():
        raise ValueError("keep() rejected every cube")
    tets = full.tets[np.tile(mask, 6)]  # tets are type-major: 6 x C blocks
    used = np.unique(tets)
    remap = np.full(full.num_particles, -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    tets = remap[tets]
    edges = _derive_edges(tets) if with_edges else None
    return TetMesh(verts=full.verts[used], tets=tets, edges=edges)


def ellipsoid_mesh(n: int = 12, radii=(0.5, 0.5, 0.5),
                   cell: Optional[float] = None, center=(0.0, 1.0, 0.0),
                   with_edges: bool = False) -> TetMesh:
    """Solid tet ellipsoid (a sphere for equal radii): a masked grid of about
    n cubes across each diameter."""
    radii = np.asarray(radii, np.float32)
    c = np.asarray(center, np.float32)
    if cell is None:
        cell = float(2.0 * radii.max() / n)
    dims = tuple(int(np.ceil(2.0 * r / cell)) + 1 for r in radii)
    origin = tuple(c - np.asarray(dims) * cell / 2.0)

    def keep(centers):
        return np.sum(((centers - c) / radii) ** 2, axis=-1) <= 1.0

    return masked_grid_mesh(*dims, keep, cell=cell, origin=origin,
                            with_edges=with_edges)


def with_boundary_surface(mesh: TetMesh) -> TetMesh:
    """The mesh with its own boundary triangles as its render surface: each
    surface vertex is a boundary particle, skinned with weight 1 at one
    corner of an incident tet, and faces are wound outward (normal away
    from the owning tet's centroid)."""
    tets = mesh.tets
    # faces opposite each corner; a face seen once across the mesh is boundary
    face_corners = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]
    faces = np.concatenate([tets[:, list(c)] for c in face_corners], axis=0)
    owner = np.tile(np.arange(tets.shape[0], dtype=np.int64), 4)
    _, first, counts = np.unique(np.sort(faces, axis=1), axis=0,
                                 return_index=True, return_counts=True)
    sel = first[counts == 1]
    bfaces = faces[sel]
    bowner = owner[sel]

    v = mesh.verts
    tc = v[tets[bowner]].mean(axis=1)
    p0, p1, p2 = v[bfaces[:, 0]], v[bfaces[:, 1]], v[bfaces[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    inward = np.einsum("ij,ij->i", n, (p0 + p1 + p2) / 3.0 - tc) < 0.0
    bfaces[inward] = bfaces[inward][:, [0, 2, 1]]

    surf_pids, tri_idx = np.unique(bfaces, return_inverse=True)
    tris = tri_idx.reshape(bfaces.shape).astype(np.int32)
    # one incident tet and corner per surface particle (the last one seen)
    tet_of = np.full(mesh.num_particles, -1, np.int64)
    corner_of = np.zeros(mesh.num_particles, np.int64)
    for k in range(4):
        col = tets[:, k]
        tet_of[col] = np.arange(tets.shape[0])
        corner_of[col] = k
    cb = corner_of[surf_pids]
    # bary (b0, b1, b2), b3 = 1 - b0 - b1 - b2: the corner's indicator
    vis_bary = np.zeros((len(surf_pids), 3), np.float32)
    vis_bary[cb < 3, cb[cb < 3]] = 1.0  # corner 3 -> all zeros
    return dataclasses.replace(mesh, vis_tet_ids=tet_of[surf_pids].astype(np.int32),
                               vis_bary=vis_bary, tris=tris)


def single_tet_mesh() -> TetMesh:
    """One tet on the unit axes, for small checks."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    return TetMesh(verts=verts, tets=np.array([[0, 1, 2, 3]], np.int32))


# ---------------------------------------------------------------------------
# Mesh I/O: npz files with the dragon asset's keys, and TetGen .node/.ele
# pairs
# ---------------------------------------------------------------------------


def save_npz(path: str, mesh: TetMesh) -> None:
    """Write a TetMesh with the keys of the bundled dragon asset."""
    data = {"verts": mesh.verts, "tet_ids": mesh.tets}
    if mesh.edges is not None:
        data["edge_ids"] = mesh.edges
    if mesh.vis_tet_ids is not None:
        data["vis_tet_ids"] = mesh.vis_tet_ids
        data["vis_bary"] = mesh.vis_bary
        data["tri_ids"] = mesh.tris
    np.savez_compressed(path, **data)


def load_npz(path: str) -> TetMesh:
    """Read a TetMesh written by ``save_npz`` (or the dragon asset)."""
    with np.load(path) as z:
        def opt(key, dtype):
            return z[key].astype(dtype) if key in z else None

        return TetMesh(
            verts=z["verts"].astype(np.float32),
            tets=z["tet_ids"].astype(np.int32),
            edges=opt("edge_ids", np.int32),
            vis_tet_ids=opt("vis_tet_ids", np.int32),
            vis_bary=opt("vis_bary", np.float32),
            tris=opt("tri_ids", np.int32),
        )


def _read_tetgen_table(path: str) -> list:
    """The rows of a TetGen whitespace table, header first, as lists of
    floats (rows may differ in length); ``#`` starts a comment."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([float(x) for x in line.split()])
    if not rows:
        raise ValueError(f"{path}: empty TetGen file")
    return rows


def load_tetgen(node_path: str, ele_path: str) -> TetMesh:
    """Read a TetGen .node/.ele pair.  Node numbering may start at 0 or 1
    and rows may carry attribute columns; tets are reoriented to positive
    volume, and the wireframe edges are the tets' unique edges."""
    nodes = _read_tetgen_table(node_path)
    n_nodes = int(nodes[0][0])
    body = nodes[1:1 + n_nodes]
    ids = np.array([r[0] for r in body])
    verts = np.array([r[1:4] for r in body], np.float32)
    base = int(ids.min())

    eles = _read_tetgen_table(ele_path)
    n_tets = int(eles[0][0])
    tets = np.array([r[1:5] for r in eles[1:1 + n_tets]], np.int64) - base
    if tets.min() < 0 or tets.max() >= n_nodes:
        raise ValueError("TetGen .ele references nodes outside the .node file")
    tets = tets.astype(np.int32)

    # positive orientation, as grid_mesh's
    p = verts[tets]
    d = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=-1)
    neg = np.linalg.det(d) < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    return TetMesh(verts=verts, tets=tets, edges=_derive_edges(tets))
