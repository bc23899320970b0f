"""Plain reference of ``dragon_nh_ordered``: the reference's dragon
(Dragon.js, read from its ``.npz`` by path), stable Neo-Hookean XPBD,
Gauss-Seidel in the reference's own order, 5 substeps a 60 Hz frame.

zalo/TetSim's CPU solver projects the tets one after another in mesh
order.  The same order in levels: tet i's level is one more than the
highest level of any earlier tet it shares a vertex with, so the tets of a
level share no vertex and every tet comes after each earlier tet it
touches (``ordered_levels``, written here from that rule).  The levels are
the colours handed to ``_xpbd``.

A batch is drawn as the dense engine draws it: each body offset by a
seeded uniform translation of at most ``jitter`` per axis, numpy's
RandomState of the seed drawing a [1, 3, B] block (an axis, then the
bodies), y made non-negative.

The dense engine's substep departs from the port's other Neo-Hookean
substep twice, and neither departure acts here: its prediction is not
gated by the inverse mass (``_xpbd``'s is), and every particle of the
dragon has mass; its grab overrides its particle after the ground's
friction (as ``_xpbd``'s does), and an ahead batch holds no grab.

A frame is ``_xpbd.frame``'s, written out here so that on the card each
substep's walk of the levels is replayed from a CUDA graph: 703 levels of
some 160 small torch calls each take about 1.4 ms of the host a level
when launched one by one (49-61 s for a run's 10 frames), and the graph
launches the same kernels, with the same bits, without the host.  On the
CPU the walk runs call by call.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench.reference import _xpbd


def ordered_levels(tets: np.ndarray, num_particles: int) -> np.ndarray:
    """Each tet's level: 1 + the highest level among the earlier tets that
    share a vertex with it (0 where none does)."""
    top = np.full(num_particles, -1, np.int64)  # highest level at a vertex
    out = np.empty(len(tets), np.int64)
    for i, tet in enumerate(tets.tolist()):
        out[i] = top[tet].max() + 1
        top[tet] = out[i]
    return out


class Reference:
    def __init__(self, config: dict, traffic: dict, root: str, device,
                 dtype=torch.float32):
        with np.load(os.path.join(root, config["mesh"])) as z:
            self.verts = z["verts"].astype(np.float32)
            tets = z["tet_ids"].astype(np.int64)
        if config["coloring"] != "ordered":
            raise ValueError("this reference runs the reference's order")
        self.traffic, self.device, self.dtype = traffic, device, dtype
        self.physics = _xpbd.Physics.of(config)
        ir, vol = _xpbd.inverse_rest(self.verts[tets])
        irv = np.where(vol != 0, np.float32(1.0) / np.where(vol != 0, vol, 1),
                       0).astype(np.float32)
        inv_mass = _xpbd.lumped_inv_mass(tets, vol, len(self.verts),
                                         config["density"])
        self.levels = _xpbd.levels(
            tets, ordered_levels(tets, len(self.verts)), ir, irv, inv_mass,
            device, dtype)
        self.inv_mass = torch.as_tensor(inv_mass, device=device).to(dtype)
        self._graph = self._static = None  # the card's walk (``_graph_walk``)

    def initial(self, inputs: dict):
        """(pos, vel) [B, N, 3] before the first frame."""
        b = int(self.traffic["bodies"])
        verts = np.repeat(self.verts[None], b, axis=0)
        jitter = float(self.traffic.get("jitter", 0.0))
        if jitter:
            rng = np.random.RandomState(int(inputs["seed"]) % 2**32)
            off = rng.uniform(-jitter, jitter, (1, 3, b)).astype(np.float32)
            off[:, 1] = np.abs(off[:, 1])
            verts = verts + off[0].T[:, None, :]
        pos = torch.as_tensor(verts, device=self.device).to(self.dtype)
        return pos, torch.zeros_like(pos)

    def _walk(self, pos):
        """The levels in order on pos [B, N, 3], in place."""
        for lv in self.levels:
            corners = pos[:, lv.ids]  # [B, C, 4, 3]
            pos[:, lv.ids.reshape(-1)] = _xpbd.project(
                corners, lv, self.physics).reshape(pos.shape[0], -1, 3)
        return pos

    def _graph_walk(self, pos):
        """``_walk`` on the card, replayed from a CUDA graph captured at
        the first call (the walk runs once first, outside the capture, to
        warm the allocator)."""
        if self._graph is None:
            self._static = pos.clone()
            self._walk(self._static.clone())
            torch.cuda.synchronize(pos.device)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._walk(self._static)
        self._static.copy_(pos)
        self._graph.replay()
        return self._static.clone()

    def frame(self, pos, vel, grab=None):
        """One frame of B bodies from pos, vel [B, N, 3]; ``grab`` None or
        (particle, target [3]) held on every body."""
        ph = self.physics
        dt = float(ph.dt)
        pos, vel = pos.to(self.dtype), vel.to(self.dtype)
        walk = (self._graph_walk if torch.device(pos.device).type == "cuda"
                else self._walk)
        movable = (self.inv_mass > 0)[:, None]
        wmin = torch.as_tensor(ph.wmin, device=pos.device).to(pos.dtype)
        wmax = torch.as_tensor(ph.wmax, device=pos.device).to(pos.dtype)
        for _ in range(ph.substeps):
            vel = vel.clone()
            vel[..., 1] += float(ph.gdt)
            vel = torch.where(movable, vel, 0)
            prev = pos
            pos = walk(pos + vel * dt)
            pos = torch.minimum(torch.maximum(pos, wmin), wmax)
            below = pos[..., 1] < 0
            k = float(ph.k_fric)
            pos = torch.stack([
                torch.where(below, pos[..., 0] + (prev[..., 0] - pos[..., 0])
                            * k, pos[..., 0]),
                torch.where(below, 0, pos[..., 1]),
                torch.where(below, pos[..., 2] + (prev[..., 2] - pos[..., 2])
                            * k, pos[..., 2])], dim=-1)
            if grab is not None:
                pos[:, grab[0]] = torch.as_tensor(
                    np.asarray(grab[1], np.float32),
                    device=pos.device).to(pos.dtype)
            vel = (pos - prev) / dt
        return pos, vel
