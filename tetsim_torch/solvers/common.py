"""Substep phases shared by the solver backends (counterpart of
``tetsim_tpu/solvers/common.py``):

  predict -> constraint solve -> collide -> grab -> velocity update.

Gravity enters in prediction and the world bounds come from the params.
Every function takes positions [..., N, 3] (a leading body axis is allowed)
and returns new tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import PhysicsParams
from ..state import Controls


def predict(pos, vel, dt, params: PhysicsParams, inv_mass=None):
    """Integrate gravity into velocity, save prev_pos, advect positions.
    Pinned particles (inv_mass == 0) keep zero velocity and do not move."""
    vel = vel.clone()
    vel[..., 1] += params.gravity * dt
    if inv_mass is not None:
        vel = torch.where((inv_mass > 0.0)[..., None], vel, 0.0)
    prev_pos = pos
    pos = pos + vel * dt
    return pos, prev_pos, vel


def collide(pos, prev_pos, dt, params: PhysicsParams):
    """World-bounds clamp + ground plane with simple friction: the
    tangential position of a grounded particle is pulled back toward
    prev_pos by min(1, dt*friction)."""
    wmin = torch.as_tensor(params.world_min, device=pos.device)
    wmax = torch.as_tensor(params.world_max, device=pos.device)
    pos = torch.clamp(pos, wmin, wmax)
    below = pos[..., 1] < 0.0
    x = pos[..., 0]
    y = torch.where(below, 0.0, pos[..., 1])
    z = pos[..., 2]
    k = np.minimum(np.float32(1.0), dt * params.friction)
    x = x + torch.where(below, (prev_pos[..., 0] - x) * k, 0.0)
    z = z + torch.where(below, (prev_pos[..., 2] - z) * k, 0.0)
    return torch.stack([x, y, z], dim=-1)


def apply_grab(pos, controls: Controls):
    """Hard position override of grabbed particles.  ``grab_id`` is a scalar
    (one grab) or [G] (G simultaneous grabs); negative ids are inactive."""
    return grab_override(pos, *norm_grabs(controls))


def grab_override(pos, gid, gpos):
    """pos [..., N, 3] with grabs gid int [..., G] and targets gpos
    [..., G, 3] sharing the leading axes.  A particle hit by several grabs
    takes the last one."""
    n, g = pos.shape[-2], gid.shape[-1]
    hit = torch.arange(n, device=pos.device)[:, None] == gid[..., None, :]
    which = torch.where(hit, torch.arange(g, device=pos.device), -1)
    which = which.max(dim=-1).values  # [..., N]
    idx = which.clamp(min=0)[..., None].expand(*which.shape, 3)
    target = torch.gather(gpos, -2, idx)
    return torch.where((which >= 0)[..., None], target, pos)


def norm_grabs(controls: Controls):
    """Controls -> (gid int32 [G], gpos f32 [G,3]); a scalar grab becomes
    G=1.  Negative ids are inactive."""
    gid = torch.as_tensor(controls.grab_id)
    gpos = torch.as_tensor(controls.grab_pos, dtype=torch.float32)
    if gid.ndim == 0:
        gid = gid[None]
    return gid.to(torch.int32), gpos.reshape(gid.shape[0], 3)


def velocity_update(pos, prev_pos, dt):
    """vel = (pos - prev_pos) / dt, a true division on every device (torch
    on CUDA would multiply by the reciprocal of a host scalar)."""
    return (pos - prev_pos) / pos.new_full((), dt)
