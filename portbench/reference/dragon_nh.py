"""Plain reference of ``dragon_nh``: the reference's dragon (Dragon.js,
read from its ``.npz`` by path), stable Neo-Hookean XPBD, Gauss-Seidel over
a first-fit greedy colouring of the tets in mesh order, 5 substeps a
60 Hz frame; the surface skinned barycentrically from its tets, with
area-weighted normals.  A batch is drawn as the mix says: each body
offset by a seeded uniform translation of at most ``jitter`` per axis
(numpy's RandomState of the seed, y made non-negative)."""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench.reference import _xpbd


class Reference:
    def __init__(self, config: dict, traffic: dict, root: str, device,
                 dtype=torch.float32):
        with np.load(os.path.join(root, config["mesh"])) as z:
            self.verts = z["verts"].astype(np.float32)
            tets = z["tet_ids"].astype(np.int64)
            vis_tet_ids = z["vis_tet_ids"].astype(np.int64)
            bary = z["vis_bary"].astype(np.float32)
            tris = z["tri_ids"].astype(np.int64)
        if config["coloring"] != "greedy":
            raise ValueError("this reference colours greedily")
        self.traffic, self.device, self.dtype = traffic, device, dtype
        self.physics = _xpbd.Physics.of(config)
        ir, vol = _xpbd.inverse_rest(self.verts[tets])
        irv = np.where(vol != 0, np.float32(1.0) / np.where(vol != 0, vol, 1),
                       0).astype(np.float32)
        inv_mass = _xpbd.lumped_inv_mass(tets, vol, len(self.verts),
                                         config["density"])
        self.levels = _xpbd.levels(tets, _xpbd.first_fit_colors(tets), ir,
                                   irv, inv_mass, device, dtype)
        self.inv_mass = torch.as_tensor(inv_mass, device=device).to(dtype)
        w = np.concatenate([bary, np.float32(1.0) - bary.sum(1, keepdims=True)],
                           axis=1).astype(np.float32)
        self.skin_ids = torch.as_tensor(tets[vis_tet_ids], device=device)
        self.skin_w = torch.as_tensor(w, device=device).to(dtype)
        self.tris = torch.as_tensor(tris, device=device)

    def initial(self, inputs: dict):
        """(pos, vel) [B, N, 3] before the first frame."""
        b = int(self.traffic["bodies"])
        verts = np.repeat(self.verts[None], b, axis=0)
        jitter = float(self.traffic.get("jitter", 0.0))
        if jitter:
            rng = np.random.RandomState(int(inputs["seed"]) % 2**32)
            off = rng.uniform(-jitter, jitter, (b, 3)).astype(np.float32)
            off[:, 1] = np.abs(off[:, 1])
            verts = verts + off[:, None, :]
        pos = torch.as_tensor(verts, device=self.device).to(self.dtype)
        return pos, torch.zeros_like(pos)

    def frame(self, pos, vel, grab=None):
        return _xpbd.frame(pos.to(self.dtype), vel.to(self.dtype), self.levels,
                           self.inv_mass, self.physics, grab)

    def export(self, pos):
        """[2, S, 3] skinned surface and normals of one body's pos [N, 3]."""
        return _xpbd.skinned_surface(pos.to(self.dtype), self.skin_ids,
                                     self.skin_w, self.tris)
