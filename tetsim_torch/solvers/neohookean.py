"""Stable Neo-Hookean XPBD with graph-coloured Gauss-Seidel (counterpart of
``tetsim_tpu/solvers/neohookean.py``).

Per tet, a deviatoric constraint C_D = ||F||_F and a hydrostatic constraint
C_H = det F - 1 - volC/devC, each projected with XPBD (alpha =
compliance/dt^2 * invRestVolume); the hydrostatic one sees the deviatoric
update.  Tets within a colour level share no vertex, so a level is solved
as one batch and written back as a gather through the inverse index.

``step_frame`` hands the frame to ``kernels/gs_fused.gs_frame``: on a CPU
tensor that runs this plain-torch path, on a CUDA tensor it launches the
fused frame kernel once per frame.
"""
from __future__ import annotations

import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..state import SimState, Controls
from ..utils import mat3
from . import common


def _edge_matrix(p):
    """Column matrix P = [p1-p0 | p2-p0 | p3-p0]; p [...,4,3] -> [...,3,3]."""
    return torch.stack(
        [p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :],
         p[..., 3, :] - p[..., 0, :]],
        dim=-1,
    )


def _xpbd_apply(grads123, c, compliance, inv_rest_volume, w_inv, dt):
    """XPBD projection on a local batch; grads123 [...,3,3] has the
    gradients of corners 1..3 as columns.  Returns the delta [...,4,3]."""
    g123 = grads123.transpose(-1, -2)  # [...,3(corner),3(xyz)]
    g0 = -g123.sum(dim=-2, keepdim=True)
    g = torch.cat([g0, g123], dim=-2)  # [...,4,3]
    w = ((g * g).sum(dim=-1) * w_inv).sum(dim=-1)
    alpha = compliance / (dt * dt) * inv_rest_volume
    denom = w + alpha
    ok = (c != 0.0) & (w != 0.0)
    dlambda = torch.where(ok, -c / torch.where(ok, denom, 1.0), 0.0)
    return dlambda[..., None, None] * w_inv[..., None] * g


def solve_tet_batch(p, inv_rest_pose, inv_rest_volume, w_inv, dt,
                    params: PhysicsParams):
    """Project both Neo-Hookean constraints on a vertex-disjoint tet batch.

    p: [...,4,3] gathered corner positions.
    Returns (delta [...,4,3], vol_err [...]) with vol_err = det F - 1."""
    ir = inv_rest_pose

    # deviatoric: C = ||F||_F
    f = mat3.matmul(_edge_matrix(p), ir)
    r_s = torch.sqrt((f * f).sum(dim=(-1, -2)))
    r_s_inv = torch.where(r_s > 0.0, 1.0 / torch.where(r_s > 0.0, r_s, 1.0), 0.0)
    grads = mat3.matmul_t(f, ir) * r_s_inv[..., None, None]
    d_dev = _xpbd_apply(grads, r_s, params.dev_compliance, inv_rest_volume,
                        w_inv, dt)
    p = p + d_dev

    # hydrostatic: C = det F - 1 - volC/devC on the updated positions
    f = mat3.matmul(_edge_matrix(p), ir)
    df = mat3.cofactor_columns(f)
    grads = mat3.matmul_t(df, ir)
    det = (f[..., 0] * df[..., 0]).sum(dim=-1)
    c_vol = det - 1.0 - params.gamma
    d_vol = _xpbd_apply(grads, c_vol, params.vol_compliance, inv_rest_volume,
                        w_inv, dt)
    return d_dev + d_vol, det - 1.0


def project_constraints(pos, arr: TetArrays, dt, params: PhysicsParams):
    """Coloured Gauss-Seidel sweep over the levels, vectorized within each.
    pos [..., N, 3] (a leading body axis is allowed).  Returns (pos, mean
    volume error [...])."""
    if arr.slot_tets is None:
        raise ValueError(
            "neohookean engine needs a GS schedule: build_arrays(..., "
            "coloring='ordered'|'greedy')"
        )
    levels = zip(
        arr.slot_tets.long().unbind(0), arr.slot_inv_rest_pose.unbind(0),
        arr.slot_inv_rest_volume.unbind(0), arr.slot_valid.unbind(0),
        arr.slot_inv_mass.unbind(0), arr.slot_inv.long().unbind(0),
    )
    vol_err = torch.zeros(pos.shape[:-2], dtype=pos.dtype, device=pos.device)
    for ids, irp, irv, valid, imc, inv in levels:
        p = pos[..., ids, :]  # [..., C, 4, 3]
        delta, verr = solve_tet_batch(p, irp, irv, imc, dt, params)
        delta = torch.where(valid[:, None, None], delta, 0.0)
        # scatter as gather: each particle is touched by <= 1 corner per level
        new_corners = (p + delta).flatten(-3, -2)  # [..., C*4, 3]
        gathered = new_corners[..., inv.clamp(min=0), :]
        pos = torch.where((inv >= 0)[:, None], gathered, pos)
        vol_err = vol_err + torch.where(valid, verr, 0.0).sum(dim=-1)
    return pos, vol_err / arr.num_tets


def substep_positions(pos, vel, arr: TetArrays, params: PhysicsParams, dt,
                      grab_id, grab_pos):
    """One XPBD substep on raw tensors: pos/vel [..., N, 3], grabs
    grab_id [..., G] and grab_pos [..., G, 3].
    Returns (pos, prev_pos, vel, vol_err [...])."""
    pos, prev_pos, vel = common.predict(pos, vel, dt, params,
                                        inv_mass=arr.inv_mass)
    pos, vol_err = project_constraints(pos, arr, dt, params)
    pos = common.collide(pos, prev_pos, dt, params)
    pos = common.grab_override(pos, grab_id, grab_pos)
    vel = common.velocity_update(pos, prev_pos, dt)
    return pos, prev_pos, vel, vol_err


def substep(state: SimState, arr: TetArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One XPBD substep."""
    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, vol_err = substep_positions(
        state.pos, state.vel, arr, params, dt, gid, gpos
    )
    return state.replace(pos=pos, prev_pos=prev_pos, vel=vel), vol_err


def step_frame(state: SimState, arr: TetArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = params.num_substeps substeps, as a batch of one body of
    ``gs_fused.gs_frame``: the plain substep loop on a CPU state, one launch
    of the fused kernel on any other device (it raises where it cannot
    launch).  Returns (state, vol_errs [num_substeps])."""
    from ..kernels import gs_fused  # imports this module for its twin

    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, vol_errs = gs_fused.gs_frame(
        state.pos[None], state.vel[None], arr, params, gid[None], gpos[None],
    )
    return state.replace(pos=pos[0], prev_pos=prev_pos[0],
                         vel=vel[0]), vol_errs[0]
