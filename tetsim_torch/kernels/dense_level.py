"""The plain level solve of the dense Neo-Hookean engine's twin: both
constraints of every slot of one colour level for B bodies, between the
level's one-hot gather and scatter products (``solvers/dense.py``
``frame_reference``).

The JAX package runs this solve as XLA's fusion of ``_solve_level_planes``
(``tetsim_tpu/solvers/dense.py``).  ``dense_level_reference`` takes the
gathered corners g [4C, 3B] (row ``c*C + t`` corner c of slot t, column
``r*B + b`` coordinate r of body b) and the level's tables, and returns
the deltas d_dev + d_vol in the same layout.  On the card the frame
kernel (``kernels/dense_frame.py``) solves every level itself, with the
same arithmetic (``csrc/nh_math.cuh``'s ``solve_tet_delta``).
"""
from __future__ import annotations

import torch

from ..params import PhysicsParams


def _scales(params: PhysicsParams):
    """(compliance / dt^2 of both constraints, gamma) in f32, in the JAX
    package's operation order."""
    dt = params.dt
    return (params.dev_compliance / (dt * dt), params.vol_compliance / (dt * dt),
            params.gamma)


def _xpbd(g, c_val, scale, irv, imc):
    """XPBD on one constraint: g[j][r] the gradient of corner j+1 ([C, B]
    planes); returns the four corners' deltas."""
    gall = [[-((g[0][r] + g[1][r]) + g[2][r]) for r in range(3)]] + list(g)
    w = 0.0
    for i in range(4):
        n2 = (gall[i][0] * gall[i][0] + gall[i][1] * gall[i][1]) \
            + gall[i][2] * gall[i][2]
        w = w + n2 * imc[i]
    alpha = scale * irv
    ok = (c_val != 0.0) & (w != 0.0)
    dlam = torch.where(ok, -c_val / torch.where(ok, w + alpha, 1.0), 0.0)
    return [[dlam * imc[i] * gall[i][r] for r in range(3)] for i in range(4)]


def _deformation(p, irp):
    """F[r][c] = sum_k e[k][r] irp[3k + c], e[k] = p[k+1] - p[0]."""
    e = [[p[k + 1][r] - p[0][r] for r in range(3)] for k in range(3)]
    return [[(e[0][r] * irp[c] + e[1][r] * irp[3 + c]) + e[2][r] * irp[6 + c]
             for c in range(3)] for r in range(3)]


def dense_level_reference(g, irp, irv, imc, params: PhysicsParams):
    """The plain twin, the arithmetic of ``_solve_level_planes`` in
    ``tetsim_tpu/solvers/dense.py``: g [4C, 3B] corners, irp [9, C], irv
    [C], imc [4, C]; returns d_dev + d_vol [4C, 3B]."""
    C = irv.shape[0]
    B = g.shape[1] // 3
    g4 = g.view(4, C, 3, B)
    p = [[g4[c, :, r] for r in range(3)] for c in range(4)]
    irp = [irp[k][:, None] for k in range(9)]
    irv = irv[:, None]
    imc = [imc[c][:, None] for c in range(4)]
    dev_scale, vol_scale, gamma = _scales(params)

    # deviatoric: C = ||F||_F
    f = _deformation(p, irp)
    rs2 = 0.0
    for r in range(3):
        for c in range(3):
            rs2 = rs2 + f[r][c] * f[r][c]
    r_s = torch.sqrt(rs2)
    r_inv = torch.where(r_s > 0.0, 1.0 / torch.where(r_s > 0.0, r_s, 1.0), 0.0)
    g_dev = [[((f[r][0] * irp[3 * j] + f[r][1] * irp[3 * j + 1])
               + f[r][2] * irp[3 * j + 2]) * r_inv for r in range(3)]
             for j in range(3)]
    d_dev = _xpbd(g_dev, r_s, dev_scale, irv, imc)

    # hydrostatic: C = det F - 1 - gamma on the updated corners
    q = [[p[i][r] + d_dev[i][r] for r in range(3)] for i in range(4)]
    f = _deformation(q, irp)
    df = [[None] * 3 for _ in range(3)]  # df[r][c]: cofactor column c
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        df[0][c] = f[1][a] * f[2][b] - f[2][a] * f[1][b]
        df[1][c] = f[2][a] * f[0][b] - f[0][a] * f[2][b]
        df[2][c] = f[0][a] * f[1][b] - f[1][a] * f[0][b]
    det = (f[0][0] * df[0][0] + f[1][0] * df[1][0]) + f[2][0] * df[2][0]
    g_vol = [[(df[r][0] * irp[3 * j] + df[r][1] * irp[3 * j + 1])
              + df[r][2] * irp[3 * j + 2] for r in range(3)] for j in range(3)]
    d_vol = _xpbd(g_vol, (det - 1.0) - gamma, vol_scale, irv, imc)
    return torch.stack([torch.stack([d_dev[c][r] + d_vol[c][r]
                                     for r in range(3)], dim=1)
                        for c in range(4)]).reshape(4 * C, 3 * B)

