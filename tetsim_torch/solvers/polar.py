"""Jacobi shape matching with Müller's robust polar decomposition
(counterpart of ``tetsim_tpu/solvers/polar.py``).

Per substep, every tet at once: gather its 4 corners and their centroid,
form the covariance between the centred corners and the rest corners
rotated by the tet's quaternion, extract the incremental rotation with a
fixed number of Müller iterations from the identity, fold it into the
quaternion, and move every particle by the rest-volume-weighted mean of
its tets' goal deltas (goal = rotated rest corner + centroid).

Every sum of a few terms is written out in a fixed order, the one the
CUDA kernel ``kernels/csrc/polar_frame.cu`` uses: the centroid
``((p0 + p1) + p2) + p3``, the covariance over corners 0..3, and a
particle's incident deltas in the column order of ``inc_idx``.

``step_frame`` hands the frame to ``kernels/polar_fused.polar_frame``: on a
CPU tensor that runs this plain-torch path, on a CUDA tensor it launches
the fused frame kernel once per frame.
"""
from __future__ import annotations

import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..state import SimState, Controls
from ..utils import mat3
from . import common

EXTRACT_ITERS = 9  # PhysicsParams.extract_iters' default
EPS = 1e-9


def quat_rotate(v, q):
    """Rotate v [...,3] by unit quaternions q [...,4] (x, y, z, w):
    v + 2 u x (u x v + w v)."""
    u, w = q[..., :3], q[..., 3:4]
    return v + 2.0 * mat3.cross(u, mat3.cross(u, v) + w * v)


def quat_mul(q1, q2):
    """Hamilton product q1 q2, xyzw layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def _norm(v):
    """Euclidean norm over the last axis, squares added in index order."""
    s = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i] * v[..., i]
    return torch.sqrt(s)


def quat_normalize(q):
    return q / _norm(q)[..., None]


def quat_to_mat(q):
    """Rotation matrix m[..., r, c] of unit quaternions; column c is the
    rotated basis vector e_c."""
    x, y, z, w = q.unbind(-1)
    cols = [
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-1)


def extract_rotation(a, q0, iters: int = EXTRACT_ITERS):
    """Müller et al., 'A Robust Method to Extract the Rotational Part of
    Deformations': ``iters`` steps rotating q toward the covariance
    a [...,3,3], from q0 [...,4].  A fixed trip count with a masked update:
    a tet whose angular step falls under EPS keeps its quaternion."""
    q = q0
    for _ in range(iters):
        r = quat_to_mat(q)
        # omega = sum_c cross(R col c, A col c) / (|sum_rc R * A| + eps)
        cr = mat3.cross(r.transpose(-1, -2), a.transpose(-1, -2))  # [...,c,3]
        num = (cr[..., 0, :] + cr[..., 1, :]) + cr[..., 2, :]
        ra = (r * a).flatten(-2)
        den = ra[..., 0]
        for i in range(1, 9):  # row-major
            den = den + ra[..., i]
        omega = num / (den.abs() + EPS)[..., None]
        angle = _norm(omega)
        live = angle >= EPS
        axis = omega / torch.where(live, angle, 1.0)[..., None]
        half = angle * 0.5
        dq = torch.cat([axis * torch.sin(half)[..., None],
                        torch.cos(half)[..., None]], dim=-1)
        q = torch.where(live[..., None], quat_mul(dq, q), q)
    return q


def goal_deltas(pos, quats, arr: TetArrays, iters: int = EXTRACT_ITERS):
    """The tets' half of a Jacobi solve on pos [..., N, 3] and quats
    [..., M, 4]: every corner's goal delta weighted by its tet's rest
    volume, [..., M*4, 3] in corner order ``tet*4 + k``, and the new
    quaternions."""
    p = pos[..., arr.tets.long(), :]  # [..., M, 4, 3]
    centroid = (((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :])
                + p[..., 3, :])[..., None, :] * 0.25
    pc = p - centroid

    rest_rot = quat_rotate(arr.rest_centered, quats[..., None, :])
    a = mat3.outer_sum(pc, rest_rot)  # a[r,c] = sum_k cur_k[r] rest_k[c]
    identity = torch.zeros_like(quats)
    identity[..., 3] = 1.0
    inc = extract_rotation(a, identity, iters)
    quats = quat_normalize(quat_mul(inc, quats))

    # goal - corner, so a body at rest is an exact fixed point
    delta = quat_rotate(arr.rest_centered, quats[..., None, :]) - pc
    w = arr.rest_volume
    return (delta * w[..., None, None]).flatten(-3, -2), quats


def particle_sums(weighted, pos, arr: TetArrays):
    """Each particle's sum of its corners' weighted deltas, [..., N, 3],
    and of their rest volumes, [N]: from the incidence table (a gather, in
    the column order of ``inc_idx``) or, when ``arr.inc_idx`` is None, by
    ``index_add_`` over the corners."""
    if arr.inc_idx is not None:
        live = (arr.inc_idx >= 0)[..., None]  # [N, K, 1]
        contrib = weighted[..., arr.inc_idx.clamp(min=0).long(), :]
        num = torch.zeros_like(pos)
        for k in range(arr.inc_idx.shape[1]):
            num = num + torch.where(live[:, k], contrib[..., k, :], 0.0)
        return num, arr.inc_den
    seg = arr.tets.reshape(-1).long()
    num = torch.zeros_like(pos).index_add_(-2, seg, weighted)
    den = torch.zeros_like(arr.inv_mass).index_add_(
        0, seg, arr.rest_volume.repeat_interleave(4))
    return num, den


def move_to_goals(pos, num, den, inv_mass):
    """Every movable particle moves by its weighted mean goal delta;
    pinned particles (inv_mass == 0) never move."""
    movable = (inv_mass > 0.0)[..., None]
    return torch.where(
        movable, pos + num / torch.clamp(den[..., None], min=EPS), pos)


def solve_shape_match(pos, quats, arr: TetArrays, iters: int = EXTRACT_ITERS):
    """One Jacobi shape-matching iteration on pos [..., N, 3] and quats
    [..., M, 4] (a leading body axis is allowed).  Returns (pos, quats)."""
    weighted, quats = goal_deltas(pos, quats, arr, iters)
    num, den = particle_sums(weighted, pos, arr)
    return move_to_goals(pos, num, den, arr.inv_mass), quats


def substep_positions(pos, vel, quats, arr: TetArrays, params: PhysicsParams,
                      dt, grab_id, grab_pos):
    """One substep on raw tensors: pos/vel [..., N, 3], quats [..., M, 4],
    grabs grab_id [..., G] and grab_pos [..., G, 3].
    Returns (pos, prev_pos, vel, quats)."""
    pos, prev_pos, vel = common.predict(pos, vel, dt, params,
                                        inv_mass=arr.inv_mass)
    pos, quats = solve_shape_match(pos, quats, arr, params.extract_iters)
    pos = common.collide(pos, prev_pos, dt, params)
    pos = common.grab_override(pos, grab_id, grab_pos)
    vel = common.velocity_update(pos, prev_pos, dt)
    return pos, prev_pos, vel, quats


def substep(state: SimState, arr: TetArrays, params: PhysicsParams, dt,
            controls: Controls):
    """One substep; its diagnostic is 0 (the polar solve has no volume
    constraint)."""
    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, quats = substep_positions(
        state.pos, state.vel, state.quats, arr, params, dt, gid, gpos)
    return (state.replace(pos=pos, prev_pos=prev_pos, vel=vel, quats=quats),
            pos.new_zeros(()))


def step_frame(state: SimState, arr: TetArrays, params: PhysicsParams,
               controls: Controls):
    """One frame = params.num_substeps substeps, as a batch of one body of
    ``polar_fused.polar_frame``: the plain substep loop on a CPU state, one
    launch of the fused kernel on any other device (it raises where it
    cannot launch).  Returns (state, vol_errs [num_substeps] of zeros)."""
    from ..kernels import polar_fused  # imports this module for its twin

    gid, gpos = common.norm_grabs(controls)
    pos, prev_pos, vel, quats = polar_fused.polar_frame(
        state.pos[None], state.vel[None], state.quats[None], arr, params,
        gid[None], gpos[None])
    zeros = pos.new_zeros((params.num_substeps,))
    return state.replace(pos=pos[0], prev_pos=prev_pos[0], vel=vel[0],
                         quats=quats[0]), zeros
