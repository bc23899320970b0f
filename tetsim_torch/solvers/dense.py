"""The dense Neo-Hookean engine: bodies batched in columns, each colour
level gathered and scattered as a whole (counterpart of
``tetsim_tpu/solvers/dense.py``).

The state is [N, 3, B].  On CUDA ``step_frame`` is one launch of
``kernels/csrc/dense_frame.cu`` a frame (``kernels/dense_frame.py``): a
block per body (past 19,370 particles, a cluster of blocks) walks every
level and substep, gathering a level's corners and scattering its deltas by
index (``DenseArrays.ids``).  On the CPU it
runs ``frame_reference``, the kernel's plain twin and the JAX package's
own form: per level one product ``onehot[l].T @ pos.view(N, 3B)`` gathers
the corners of the level's C slots for all B bodies ([4C, 3B], row
``c*C + t`` is corner c of slot t, column ``r*B + b`` coordinate r of body
b), ``dense_level_reference`` solves them (the JAX package's fusion of
``_solve_level_planes``, with the kernel's arithmetic), and
``pos.view(N, 3B).addmm_(onehot[l], delta)`` scatters the deltas back.
Both products are exact in FP32: a column of the one-hot holds one 1, and
within a level a particle is a corner of one slot at most, so every output
sums one product with zeros; the index gather and scatter are the same
operations.  TF32 would round every position to 10 mantissa bits, so on
CUDA the twin refuses to run while it is on (``check_precision``); the
kernel has no products and ignores it.  The products spread a NaN or inf
in any particle to its whole column (0 * inf = NaN), as the JAX package's
do, and the kernel spreads them the same way.

The substep is the JAX package's dense one, which differs from
``solvers/common.py``: the prediction is not gated by the inverse mass,
and the grab overrides its particle after the collision step, so the solve
does not pin it.

The one-hot, the twin's alone, is f32 [L, N, 4C]: 161.7 MB for the
dragon on the greedy colouring (L = 32, C = 256), 1.78 GB on the ordered
one (L = 703, C = 128); ``build_dense_arrays`` refuses a mesh whose slab
passes ``max_bytes``, as the JAX package does, but builds the slab only
when it is first read (``DenseArrays.onehot``: by the twin), so a body that
only steps on the card never allocates it.  The tables are the JAX
package's: the level's slots in the order of their tets' first corners, C
rounded up to 128.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels import dense_frame
from ..mesh import TetMesh, color_slots, greedy_color, level_schedule, rest_state
from ..params import PhysicsParams
from ..spans import kernel, span
from . import common

_SPAN = kernel(dense_frame.__name__)  # the frame entry's span


@dataclasses.dataclass
class DenseState:
    pos: torch.Tensor  # f32 [N, 3, B], contiguous
    prev_pos: torch.Tensor  # f32 [N, 3, B]
    vel: torch.Tensor  # f32 [N, 3, B]

    def replace(self, **changes) -> "DenseState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class DenseArrays:
    """Per-mesh constants of the dense engine, as tensors on one device."""

    ids: torch.Tensor  # int32 [L, 4C] corner slot -> particle (padding: 0)
    irp: torch.Tensor  # f32 [L, 9, C] inverse rest pose, row-major
    irv: torch.Tensor  # f32 [L, C] inverse rest volume (0: padded slot)
    imc: torch.Tensor  # f32 [L, 4, C] inverse mass of each corner
    num_particles: int
    slots_per_level: int

    @property
    def num_levels(self) -> int:
        return self.irv.shape[0]

    @functools.cached_property
    def onehot(self) -> torch.Tensor:
        """The twin's f32 [L, N, 4C] scatter matrix (gather: transposed),
        built on the tables' device when first read: a slot's column holds
        its corner's 1 where the slot holds a tet (irv != 0, as the JAX
        package tells them apart)."""
        lev, slot = torch.nonzero((self.irv != 0.0).repeat(1, 4),
                                  as_tuple=True)
        onehot = torch.zeros(
            (self.num_levels, self.num_particles, 4 * self.slots_per_level),
            dtype=torch.float32, device=self.irv.device)
        onehot[lev, self.ids[lev, slot].long(), slot] = 1.0
        return onehot


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def level_tables(mesh: TetMesh, density: float = 1000.0,
                 coloring: str = "greedy"):
    """The JAX package's per-level tables of a colouring, as numpy arrays:
    (ids int32 [L, 4C] corner slot -> particle, irp f32 [L, 9, C], irv f32
    [L, C], imc f32 [L, 4, C]).  C is the largest level rounded up to 128;
    a level's tets take its first slots in the order of their first
    corner's particle id (stable), the other slots hold zeros."""
    ir, irv_t, _, im, _ = rest_state(mesh, density)
    tets, n = mesh.tets, mesh.num_particles
    if coloring == "greedy":
        colors = greedy_color(tets, n)
    elif coloring == "ordered":
        colors = level_schedule(tets, n)
    else:
        raise ValueError(f"unknown coloring {coloring!r}")
    slots = color_slots(colors)  # [L, Cmax] of tet ids, -1 padded
    L, cmax = slots.shape
    C = _round_up(max(cmax, 1), 128)
    ids = np.zeros((L, 4 * C), np.int32)
    irp = np.zeros((L, 9, C), np.float32)
    irv = np.zeros((L, C), np.float32)
    imc = np.zeros((L, 4, C), np.float32)
    for l in range(L):
        e = slots[l][slots[l] >= 0]
        e = e[np.argsort(tets[e, 0], kind="stable")]
        t = np.arange(len(e))
        for c in range(4):
            ids[l, c * C + t] = tets[e, c]
            imc[l, c, t] = im[tets[e, c]]
        irp[l, :, t] = ir[e].reshape(-1, 9)
        irv[l, t] = irv_t[e]
    return ids, irp, irv, imc


def build_dense_arrays(mesh: TetMesh, density: float = 1000.0,
                       coloring: str = "greedy",
                       max_bytes: int = 2_000_000_000, *, device) -> DenseArrays:
    """The level tables on ``device``; raises ValueError where the twin's
    one-hot slab would pass ``max_bytes`` (the slab itself is built when
    the twin first reads it)."""
    ids, irp, irv, imc = level_tables(mesh, density, coloring)
    n, (L, C) = mesh.num_particles, irv.shape
    nbytes = L * n * 4 * C * 4
    if nbytes > max_bytes:
        raise ValueError(
            f"dense GS one-hot slab would need {nbytes/1e9:.1f} GB "
            f"(L={L}, N={n}, 4C={4*C}); use the classic neohookean engine "
            "for meshes this large"
        )
    return DenseArrays(
        ids=torch.as_tensor(ids).to(device),
        irp=torch.as_tensor(irp).to(device),
        irv=torch.as_tensor(irv).to(device),
        imc=torch.as_tensor(imc).to(device),
        num_particles=n, slots_per_level=C,
    )


def init_dense_state(mesh: TetMesh, num_bodies: int, jitter: float = 0.0,
                     seed: int = 0, *, device) -> DenseState:
    """B copies of the rest shape in columns, each body offset by a seeded
    random translation (y kept non-negative), drawn as the JAX package
    draws it."""
    pos = np.broadcast_to(mesh.verts.astype(np.float32)[:, :, None],
                          (mesh.num_particles, 3, num_bodies)).copy()
    if jitter:
        rng = np.random.RandomState(seed)
        off = rng.uniform(-jitter, jitter, (1, 3, num_bodies)).astype(np.float32)
        off[:, 1] = np.abs(off[:, 1])
        pos = pos + off
    pos = torch.as_tensor(pos).to(device)
    return DenseState(pos=pos, prev_pos=pos, vel=torch.zeros_like(pos))


def check_precision() -> None:
    """Raise unless CUDA float32 products run in full FP32: the twin's
    one-hot products are exact only there (the JAX package asks for
    HIGHEST)."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the dense engine's twin needs full-FP32 matrix products, but "
            f"TF32 is on (float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}, "
            f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}): its "
            "one-hot gather and scatter would round every position; call "
            "torch.set_float32_matmul_precision('highest')")


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
    """The twin's level solve, the arithmetic of ``_solve_level_planes`` in
    ``tetsim_tpu/solvers/dense.py`` (and of ``csrc/nh_math.cuh``'s
    ``solve_tet_delta``, the kernel's): g [4C, 3B] corners (row ``c*C + t``
    corner c of slot t, column ``r*B + b`` coordinate r of body b), irp [9,
    C], irv [C], imc [4, C]; returns d_dev + d_vol [4C, 3B]."""
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


def project_constraints(pos, arr: DenseArrays, params: PhysicsParams):
    """The twin's coloured Gauss-Seidel sweep on pos [N, 3, B]
    (contiguous), updated in place level by level: the one-hot gather, the
    level's plain solve, the one-hot scatter."""
    n, _, B = pos.shape
    flat = pos.view(n, 3 * B)
    for l in range(arr.num_levels):
        g = arr.onehot[l].T @ flat  # [4C, 3B] corners
        delta = dense_level_reference(g, arr.irp[l], arr.irv[l], arr.imc[l],
                                      params)
        flat.addmm_(arr.onehot[l], delta)  # exact: one term per row
    return pos


def substep(state: DenseState, arr: DenseArrays, params: PhysicsParams,
            grab_id, grab_pos) -> DenseState:
    """One XPBD substep of the twin on [N, 3, B]: grab_id int32 [B] (-1
    inactive), grab_pos f32 [3, B]."""
    if state.pos.device.type == "cuda":
        check_precision()
    dt = params.dt
    vel = state.vel.clone()
    vel[:, 1] += params.gravity * dt
    prev = state.pos
    pos = prev + vel * dt  # a new tensor: the sweep updates it in place
    project_constraints(pos, arr, params)

    # collide: the world bounds, then the ground with friction
    for r in range(3):
        pos[:, r].clamp_(float(params.world_min[r]), float(params.world_max[r]))
    below = pos[:, 1] < 0.0
    pos[:, 1] = torch.where(below, 0.0, pos[:, 1])
    k = np.minimum(np.float32(1.0), dt * params.friction)
    for ax in (0, 2):
        pos[:, ax] += torch.where(below, (prev[:, ax] - pos[:, ax]) * k, 0.0)

    # per-body grab override
    hit = torch.arange(pos.shape[0], device=pos.device)[:, None] == grab_id
    pos = torch.where(hit[:, None, :], grab_pos, pos)
    return DenseState(pos=pos, prev_pos=prev,
                      vel=common.velocity_update(pos, prev, dt))


def frame_reference(state: DenseState, arr: DenseArrays,
                    params: PhysicsParams, grab_id, grab_pos) -> DenseState:
    """The frame kernel's plain twin on any device: ``params.num_substeps``
    substeps of products and plain level solves."""
    for _ in range(params.num_substeps):
        state = substep(state, arr, params, grab_id, grab_pos)
    return state


def step_frame(state: DenseState, arr: DenseArrays, params: PhysicsParams,
               grab_id, grab_pos) -> DenseState:
    """``params.num_substeps`` substeps: on CPU tensors the plain twin, on
    any other device one launch of the frame kernel (or it raises); the
    span of ``kernels/dense_frame.py``'s entry either way."""
    with span(_SPAN):
        if state.pos.device.type == "cpu" or params.num_substeps == 0:
            return frame_reference(state, arr, params, grab_id, grab_pos)
        return DenseState(*dense_frame.dense_frame(
            state.pos, state.vel, arr, params, grab_id, grab_pos))
