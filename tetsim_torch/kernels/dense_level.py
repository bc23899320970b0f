"""The level solve of the dense Neo-Hookean engine (``csrc/dense_level.cu``):
both constraints of every slot of one colour level for B bodies, between
the level's one-hot gather and scatter products (``solvers/dense.py``).

Replaces no TPU kernel: the JAX package runs this solve as XLA's fusion of
``_solve_level_planes`` (``tetsim_tpu/solvers/dense.py``).  ``dense_level``
takes the gathered corners g [4C, 3B] (row ``c*C + t`` corner c of slot
t, column ``r*B + b`` coordinate r of body b) and the level's tables, and
returns the deltas d_dev + d_vol in the same layout: on CUDA tensors one
launch of the kernel, on CPU tensors ``dense_level_reference``, its
plain-torch twin.  ``launch_count`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..params import PhysicsParams
from . import build
from .batch import expect

THREADS = 256  # threads per block (kThreads)
FLOPS_PER_SLOT = 421  # one tet's projection, as gs_fused.frame_flops counts it
NVCC_FLAGS = ()  # the library's own nvcc flags

launch_count = 0  # kernel launches since import (or reset)


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments
    declared."""
    lib = build.load("dense_level", NVCC_FLAGS)
    if lib.dense_level_launch.argtypes is None:
        lib.dense_level_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
            + [ctypes.c_void_p])
        lib.dense_level_launch.restype = ctypes.c_int
        lib.dense_level_error_string.argtypes = [ctypes.c_int]
        lib.dense_level_error_string.restype = ctypes.c_char_p
        lib.dense_level_threads.restype = ctypes.c_int
        if lib.dense_level_threads() != THREADS:
            raise RuntimeError("csrc/dense_level.cu kThreads != "
                               "dense_level.THREADS")
    return lib


def _scales(params: PhysicsParams):
    """(compliance / dt^2 of both constraints, gamma) in f32, in the JAX
    package's operation order."""
    dt = params.dt
    return (params.dev_compliance / (dt * dt), params.vol_compliance / (dt * dt),
            params.gamma)


def _dense_level_cuda(g, irp, irv, imc, params: PhysicsParams):
    global launch_count
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"the dense level kernel runs on CUDA, not {dev}")
    C = irv.shape[0]
    rows, cols = g.shape
    if rows != 4 * C or cols % 3:
        raise ValueError(f"g: expected [4C, 3B] with C={C}, got {list(g.shape)}")
    f32 = torch.float32
    expect(g, "g", f32, (4 * C, cols), dev)
    expect(irp, "irp", f32, (9, C), dev)
    expect(irv, "irv", f32, (C,), dev)
    expect(imc, "imc", f32, (4, C), dev)
    d = torch.empty_like(g)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.dense_level_launch(
            g.data_ptr(), irp.data_ptr(), irv.data_ptr(), imc.data_ptr(),
            d.data_ptr(), C, cols // 3, *_scales(params),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("dense_level launch failed: "
                           f"{lib.dense_level_error_string(err).decode()}")
    launch_count += 1
    return d


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


def dense_level(g, irp, irv, imc, params: PhysicsParams):
    """One level's deltas (see the twin).  CPU tensors take the plain twin;
    any other device launches the kernel or raises."""
    if g.device.type == "cpu":
        return dense_level_reference(g, irp, irv, imc, params)
    return _dense_level_cuda(g, irp, irv, imc, params)


def level_flops(num_tets: int, num_bodies: int) -> int:
    """Floating-point operations the level needs: ``FLOPS_PER_SLOT`` per
    tet of the level and body."""
    return FLOPS_PER_SLOT * num_tets * num_bodies


def level_bytes(C: int, num_bodies: int) -> int:
    """Bytes the level must move: g read and d written ([4C, 3B] f32 each)
    and the tables read (14 f32 per slot)."""
    return 2 * 4 * C * 3 * num_bodies * 4 + 14 * C * 4
