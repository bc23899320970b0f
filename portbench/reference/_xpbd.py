"""Stable Neo-Hookean XPBD with coloured Gauss-Seidel, in plain PyTorch.

The reference arithmetic of every configuration here, written from the
method and not from the port: per tet a deviatoric constraint C = ||F||_F,
then a hydrostatic one C = det F - 1 - vol/dev compliance on the corners
the first moved, each projected with XPBD (alpha = compliance / dt^2 /
rest volume); the tets of one colour share no vertex and are projected at
once; a substep is predict (gravity, pinned particles held), the colours
in order, the world box and the ground with friction, the grab, and the
velocity from the step.  A frame is ``num_substeps`` substeps.

Every tensor is in ``dtype``: float32, the configurations' precision, or
a lower one for the control.  Products of 3x3 matrices are written as
broadcast sums, so no matrix unit (and no TF32) takes part.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

@dataclasses.dataclass
class Physics:
    """The frame's scalars, computed in float32 from the configuration."""

    substeps: int
    dt: np.float32
    gdt: np.float32  # gravity * dt
    k_fric: np.float32  # min(1, dt * friction)
    dev_scale: np.float32  # dev_compliance / dt^2
    vol_scale: np.float32  # vol_compliance / dt^2
    gamma: np.float32  # vol_compliance / dev_compliance
    wmin: np.ndarray
    wmax: np.ndarray

    @staticmethod
    def of(config: dict) -> "Physics":
        f = np.float32
        n = int(config["num_substeps"])
        dt = f(config["time_scale"]) * f(config["time_step"]) / f(n)
        dev, vol = f(config["dev_compliance"]), f(config["vol_compliance"])
        return Physics(
            substeps=n, dt=dt, gdt=f(config["gravity"]) * dt,
            k_fric=np.minimum(f(1.0), dt * f(config["friction"])),
            dev_scale=dev / (dt * dt), vol_scale=vol / (dt * dt),
            gamma=vol / dev,
            wmin=np.asarray(config["world_min"], np.float32),
            wmax=np.asarray(config["world_max"], np.float32))


def inverse_rest(p: np.ndarray):
    """Rest corners p [M, 4, 3] f32 -> (inverse edge matrix [M, 3, 3] f32,
    rest volume [M] f32), inverted and measured in float64."""
    d = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=-1).astype(np.float64)
    return (np.linalg.inv(d).astype(np.float32),
            (np.linalg.det(d) / 6.0).astype(np.float32))


def lumped_inv_mass(tets: np.ndarray, vol: np.ndarray, n: int,
                    density: float) -> np.ndarray:
    """1 / mass where each tet puts a quarter of its mass on each corner."""
    mass = np.zeros(n, np.float32)
    share = vol / np.float32(4.0) * np.float32(density)
    for c in range(4):
        np.add.at(mass, tets[:, c], share)
    return np.where(mass > 0, np.float32(1.0) / np.where(mass > 0, mass, 1),
                    0).astype(np.float32)


def first_fit_colors(tets: np.ndarray) -> np.ndarray:
    """Each tet, in order, takes the least colour no earlier tet sharing a
    vertex has."""
    used: dict = {}
    colors = np.empty(len(tets), np.int64)
    for i, tet in enumerate(tets.tolist()):
        taken = 0
        for v in tet:
            taken |= used.get(v, 0)
        c = 0
        while taken >> c & 1:
            c += 1
        colors[i] = c
        for v in tet:
            used[v] = used.get(v, 0) | (1 << c)
    return colors


@dataclasses.dataclass
class Level:
    """The tets of one colour: corner ids [C, 4], inverse rest pose
    [C, 3, 3], inverse rest volume [C] and corner inverse masses [C, 4]."""

    ids: torch.Tensor
    ir: torch.Tensor
    irv: torch.Tensor
    w: torch.Tensor


def levels(tets, colors, ir, irv, inv_mass, device, dtype) -> list:
    """The colours in ascending order as ``Level``s on ``device``."""
    out = []
    for c in np.unique(colors):
        sel = np.nonzero(colors == c)[0]
        ids = tets[sel].astype(np.int64)
        out.append(Level(
            ids=torch.as_tensor(ids, device=device),
            ir=torch.as_tensor(ir[sel], device=device).to(dtype),
            irv=torch.as_tensor(irv[sel], device=device).to(dtype),
            w=torch.as_tensor(inv_mass[ids], device=device).to(dtype)))
    return out


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _deformation(p, ir):
    """F[r, c] = sum_k (p[k+1] - p[0])[r] * ir[k, c]; p [..., 4, 3]."""
    e = p[..., 1:, :] - p[..., :1, :]  # [..., k, r]
    return (e[..., :, :, None] * ir[..., :, None, :]).sum(-3)


def _xpbd(g, c, scale, irv, w):
    """Corner deltas [..., 4, 3] of one constraint with value c and the
    gradients g [..., 3, 3] of corners 1-3 (corner 0: minus their sum)."""
    gall = torch.cat([-g.sum(-2, keepdim=True), g], dim=-2)
    wsum = ((gall * gall).sum(-1) * w).sum(-1)
    ok = (c != 0) & (wsum != 0)
    dl = torch.where(ok, -c / torch.where(ok, wsum + scale * irv, 1), 0)
    return dl[..., None, None] * w[..., None] * gall


def project(p, lv: Level, ph: Physics):
    """Both constraints on the tets of one level; p [..., C, 4, 3]."""
    ir = lv.ir
    f = _deformation(p, ir)
    rs = torch.sqrt((f * f).sum((-1, -2)))
    rinv = torch.where(rs > 0, 1 / torch.where(rs > 0, rs, 1), 0)
    g = (f[..., None, :, :] * ir[..., :, None, :]).sum(-1) * rinv[..., None, None]
    d_dev = _xpbd(g, rs, float(ph.dev_scale), lv.irv, lv.w)

    f = _deformation(p + d_dev, ir)
    cols = [f[..., :, c] for c in range(3)]
    cof = torch.stack([_cross(cols[(c + 1) % 3], cols[(c + 2) % 3])
                       for c in range(3)], dim=-1)  # cofactor, by columns
    det = (f[..., :, 0] * cof[..., :, 0]).sum(-1)
    g = (cof[..., None, :, :] * ir[..., :, None, :]).sum(-1)
    d_vol = _xpbd(g, det - 1 - float(ph.gamma), float(ph.vol_scale),
                  lv.irv, lv.w)
    return p + d_dev + d_vol


def frame(pos, vel, lvls: list, inv_mass, ph: Physics, grab=None):
    """One frame of B bodies: pos, vel [B, N, 3]; ``grab`` None or
    (particle, target [3]) held on every body.  Returns (pos, vel)."""
    dt = float(ph.dt)
    movable = (inv_mass > 0)[:, None]
    wmin = torch.as_tensor(ph.wmin, device=pos.device).to(pos.dtype)
    wmax = torch.as_tensor(ph.wmax, device=pos.device).to(pos.dtype)
    for _ in range(ph.substeps):
        vel = vel.clone()
        vel[..., 1] += float(ph.gdt)
        vel = torch.where(movable, vel, 0)
        prev = pos
        pos = pos + vel * dt
        for lv in lvls:
            corners = pos[:, lv.ids]  # [B, C, 4, 3]
            pos[:, lv.ids.reshape(-1)] = project(corners, lv, ph).reshape(
                pos.shape[0], -1, 3)
        pos = torch.minimum(torch.maximum(pos, wmin), wmax)
        below = pos[..., 1] < 0
        k = float(ph.k_fric)
        pos = torch.stack([
            torch.where(below, pos[..., 0] + (prev[..., 0] - pos[..., 0]) * k,
                        pos[..., 0]),
            torch.where(below, 0, pos[..., 1]),
            torch.where(below, pos[..., 2] + (prev[..., 2] - pos[..., 2]) * k,
                        pos[..., 2])], dim=-1)
        if grab is not None:
            pos[:, grab[0]] = torch.as_tensor(
                np.asarray(grab[1], np.float32), device=pos.device).to(pos.dtype)
        vel = (pos - prev) / dt
    return pos, vel


def skinned_surface(pos, corner_ids, weights, tris):
    """[2, S, 3]: each surface vertex its tet corners' weighted sum, and
    area-weighted vertex normals of the triangles, normalised."""
    verts = (pos[corner_ids] * weights[..., None]).sum(-2)
    p0, p1, p2 = (verts[tris[:, k]] for k in range(3))
    fn = _cross(p1 - p0, p2 - p0)
    n = torch.zeros_like(verts)
    for k in range(3):
        n.index_add_(0, tris[:, k], fn)
    length = torch.sqrt((n * n).sum(-1, keepdim=True))
    return torch.stack([verts, n / torch.clamp(length, min=1e-12)])


def distances(pos: torch.Tensor, point) -> np.ndarray:
    """Float64 distances [N] from each particle to ``point``."""
    p = pos.detach().to("cpu", torch.float64).numpy()
    return np.sqrt(((p - np.asarray(point, np.float64)) ** 2).sum(-1))
