"""Plain reference of ``box56_nh``: a box of ``dims`` cubes of edge
``cell`` from ``origin``, each cube cut into 6 tets along its monotone
paths from corner (0,0,0) to (1,1,1) (one tet per order of the axes,
oriented positively); a tet type's rest shape is that of its tet in the
first cube, the same in every cube.  Stable Neo-Hookean XPBD, Gauss-Seidel
over 48 colours, (type, cube parity in x, y, z) in that order, 5
substeps a 60 Hz frame; the starting velocities are an input.  The render
surface is the box's boundary: each boundary particle a vertex, each
boundary face a triangle wound outward, area-weighted normals."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench.reference import _xpbd


def grid(dims, cell: float, origin):
    """(verts [N, 3] f32, tets [M, 4] int64 type-major, cubes in C order,
    tet type [M], cube parity [M])."""
    nx, ny, nz = dims
    gx, gy, gz = nx + 1, ny + 1, nz + 1
    axes = [origin[a] + np.arange(g) * cell for a, g in enumerate((gx, gy, gz))]
    verts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    verts = verts.astype(np.float32)
    ci, cj, ck = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    tets = []
    for order in itertools.permutations(range(3)):
        step = np.zeros(3, np.int64)
        corners = [(ci * gy + cj) * gz + ck]
        for axis in order:
            step[axis] += 1
            corners.append(((ci + step[0]) * gy + cj + step[1]) * gz
                           + ck + step[2])
        tets.append(np.stack(corners, -1))
    tets = np.concatenate(tets).astype(np.int64)
    p = verts[tets]
    d = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], -1)
    flip = np.linalg.det(d) < 0
    tets[flip] = tets[flip][:, [0, 2, 1, 3]]
    parity = np.tile((ci % 2) * 4 + (cj % 2) * 2 + ck % 2, 6)
    kind = np.repeat(np.arange(6), nx * ny * nz)
    return verts, tets, kind, parity


def boundary(tets: np.ndarray, verts: np.ndarray):
    """(boundary particles [S] ascending, triangles [T, 3] into them, wound
    so that the normal points away from the face's tet)."""
    faces = np.concatenate([tets[:, [1, 2, 3]], tets[:, [0, 2, 3]],
                            tets[:, [0, 1, 3]], tets[:, [0, 1, 2]]])
    owner = np.tile(np.arange(len(tets)), 4)
    key = np.sort(faces, 1)
    n = np.int64(len(verts))
    key = (key[:, 0] * n + key[:, 1]) * n + key[:, 2]  # a face as one integer
    _, first, count = np.unique(key, return_index=True, return_counts=True)
    keep = first[count == 1]
    f, own = faces[keep], owner[keep]
    v = verts.astype(np.float64)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    inward = ((v[f].mean(1) - v[tets[own]].mean(1)) * n).sum(1) < 0
    f[inward] = f[inward][:, [0, 2, 1]]
    pids, tris = np.unique(f, return_inverse=True)
    return pids, tris.reshape(f.shape)


class Reference:
    def __init__(self, config: dict, traffic: dict, root: str, device,
                 dtype=torch.float32):
        dims = tuple(int(x) for x in config["dims"])
        verts, tets, kind, parity = grid(dims, float(config["cell"]),
                                         config["origin"])
        self.verts, self.device, self.dtype = verts, device, dtype
        self.physics = _xpbd.Physics.of(config)
        first = np.arange(6) * (len(tets) // 6)  # each type's first cube
        ir6, vol6 = _xpbd.inverse_rest(verts[tets[first]])
        vol = np.float32(vol6[0])
        ir = ir6[kind]
        irv = np.full(len(tets), np.float32(1.0) / vol, np.float32)
        inv_mass = _xpbd.lumped_inv_mass(tets, np.full(len(tets), vol),
                                         len(verts), config["density"])
        self.levels = _xpbd.levels(tets, kind * 8 + parity, ir, irv, inv_mass,
                                   device, dtype)
        self.inv_mass = torch.as_tensor(inv_mass, device=device).to(dtype)
        pids, tris = boundary(tets, verts)
        self.skin_ids = torch.as_tensor(pids[:, None], device=device)
        self.skin_w = torch.ones((len(pids), 1), device=device, dtype=dtype)
        self.tris = torch.as_tensor(tris, device=device)

    def initial(self, inputs: dict):
        """(pos, vel) [1, N, 3] before the first frame."""
        pos = torch.as_tensor(self.verts[None], device=self.device)
        return pos.to(self.dtype), inputs["vel"].to(self.device, self.dtype)

    def frame(self, pos, vel, grab=None):
        return _xpbd.frame(pos.to(self.dtype), vel.to(self.dtype), self.levels,
                           self.inv_mass, self.physics, grab)

    def export(self, pos):
        """[2, S, 3]: the boundary particles and their normals."""
        return _xpbd.skinned_surface(pos.to(self.dtype), self.skin_ids,
                                     self.skin_w, self.tris)
