"""Sharded Neo-Hookean Gauss-Seidel with a compact per-level boundary
exchange (counterpart of ``tetsim_tpu/parallel/nh_shard.py``).

The tets of a GS schedule are cut into S spatial shards (recursive
coordinate bisection of the tet centroids), each colour level's slots
regrouped shard-major.  Every shard keeps its own copy of the particle
state and applies its own tets' corner updates to it.  Per level only the
corners on particles touched by two or more shards anywhere in the
schedule (the shared particles) are exchanged: each shard writes them into
a compact [Eb, 3] buffer with exactly one writer per row (tets within a
level share no vertex), the buffers are summed across shards, and every
copy takes the sum back through the row -> particle table ``xpid``.  A
shard's copy of a particle no tet of it touches goes stale, and is never
read by that shard; the frame ends with one ownership-masked combine that
gives every particle its owner's value.  Because the tets of a level are
vertex-disjoint and each tet's solve does not depend on how the columns
are packed, the sharded frame gives the unsharded engine's numbers to f32
rounding.

The tables are built on the host with numpy, exactly as the JAX package
builds them.  ``place`` puts each shard's tables on its device; shards on
one device are stacked, so a level is a handful of torch ops for all of
them, and the exchange is one add of their buffers there plus, across
devices, one move of each device's [Eb, 3] sum to the others.  The tet
math is ``solvers/neohookean.py``'s, in plain torch: the JAX package runs
this engine in XLA, with no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..mesh import TetArrays
from ..params import PhysicsParams
from ..solvers import common
from ..solvers.neohookean import solve_tet_batch
from ..state import Controls, SimState


@dataclasses.dataclass
class NHShardTables:
    """Host-built schedule of the sharded engine, as tensors on one device.

    Shapes: L colour levels, S shards, Cs slot columns per (level, shard),
    Eb exchange rows per level (the most of any level), N particles."""

    num_particles: int
    num_tets: int
    L: int
    S: int
    Cs: int
    Eb: int
    slot_tets: torch.Tensor  # int32 [L, S, Cs, 4]
    slot_irp: torch.Tensor  # f32 [L, S, Cs, 3, 3]
    slot_irv: torch.Tensor  # f32 [L, S, Cs]
    slot_valid: torch.Tensor  # bool [L, S, Cs]
    slot_imc: torch.Tensor  # f32 [L, S, Cs, 4]
    linv: torch.Tensor  # int32 [L, S, N] corner-flat index or -1
    xw: torch.Tensor  # int32 [L, S, Cs, 4] exchange row, or Eb
    owned: torch.Tensor  # bool [S, N]
    xpid: torch.Tensor  # int32 [L, Eb] exchange row -> particle (N pads)
    inv_mass: torch.Tensor  # f32 [N]


def build_nh_shard_tables(arr: TetArrays, positions, n_shards: int
                          ) -> NHShardTables:
    """Regroup the GS schedule of ``arr`` shard-major, into ``n_shards``
    (a power of two) shards of the RCB partition of the valid slots' tet
    centroids at ``positions`` [N, 3] (the rest or initial positions), so
    that each shard's tets cluster in space and the shared particles are
    about the shards' surfaces.  The tables come back on ``arr``'s
    device."""
    if arr.slot_tets is None:
        raise ValueError(
            "sharded neohookean needs a GS schedule: build_arrays(..., "
            "coloring='ordered'|'greedy')"
        )
    S = int(n_shards)
    if S < 1 or (S & (S - 1)) != 0:
        raise ValueError(f"tet-axis size must be a power of two, got {S}")
    st = arr.slot_tets.cpu().numpy()  # [L, C, 4]
    irp = arr.slot_inv_rest_pose.cpu().numpy()  # [L, C, 3, 3]
    irv = arr.slot_inv_rest_volume.cpu().numpy()  # [L, C]
    val = arr.slot_valid.cpu().numpy().astype(bool)
    imc = arr.slot_inv_mass.cpu().numpy()  # [L, C, 4]
    inv_mass = arr.inv_mass.cpu().numpy().astype(np.float32)
    positions = np.asarray(positions, np.float32)
    L, C, _ = st.shape
    n = inv_mass.shape[0]

    # RCB over the valid slots' tet centroids: recursive median halving
    # along the widest extent gives shards balanced to one tet
    cent = positions[st.reshape(-1)].reshape(L * C, 4, 3).mean(axis=1)
    shard_of = np.zeros(L * C, np.int32)
    parts = [np.nonzero(val.reshape(-1))[0]]
    while len(parts) < S:
        nxt = []
        for part in parts:
            c = cent[part]
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0))) if len(part) else 0
            med = np.argsort(c[:, ax], kind="stable") if len(part) else []
            h = len(part) // 2
            nxt += [part[med[:h]], part[med[h:]]]
        parts = nxt
    for s, part in enumerate(parts):
        shard_of[part] = s
    shard_of = shard_of.reshape(L, C)

    mine = [[np.nonzero(val[l] & (shard_of[l] == s))[0] for s in range(S)]
            for l in range(L)]
    counts = np.array([[len(c) for c in lev] for lev in mine], np.int64)
    cs = max(1, int(counts.max()))

    sl_t = np.zeros((L, S, cs, 4), np.int32)
    sl_irp = np.zeros((L, S, cs, 3, 3), np.float32)
    sl_irv = np.zeros((L, S, cs), np.float32)
    sl_val = np.zeros((L, S, cs), bool)
    sl_imc = np.zeros((L, S, cs, 4), np.float32)
    linv = np.full((L, S, n), -1, np.int32)
    touch = np.zeros((n, S), bool)
    for l in range(L):
        for s in range(S):
            cols = mine[l][s]
            k = len(cols)
            sl_t[l, s, :k] = st[l, cols]
            sl_irp[l, s, :k] = irp[l, cols]
            sl_irv[l, s, :k] = irv[l, cols]
            sl_val[l, s, :k] = True
            sl_imc[l, s, :k] = imc[l, cols]
            corners = st[l, cols]  # [k, 4]
            touch[corners.reshape(-1), s] = True
            # corner-flat index j*4 + c into the level's [cs*4, 3] updates
            linv[l, s, corners] = (np.arange(k, dtype=np.int32)[:, None] * 4
                                   + np.arange(4, dtype=np.int32)[None, :])

    shared = touch.sum(axis=1) >= 2
    owner = np.where(touch.any(axis=1), np.argmax(touch, axis=1), 0)
    owned = owner[None, :] == np.arange(S)[:, None]  # [S, N]

    # per level, one exchange row per corner on a shared particle, in shard
    # order, then slot, then corner
    rows = [int(shared[sl_t[l][sl_val[l]].reshape(-1)].sum()) for l in range(L)]
    eb = max(1, max(rows))
    xw = np.full((L, S, cs, 4), eb, np.int32)
    xpid = np.full((L, eb), n, np.int32)
    for l in range(L):
        r = 0
        for s in range(S):
            ps = sl_t[l, s, :counts[l, s]]  # [k, 4]
            j, c = np.nonzero(shared[ps])
            xw[l, s, j, c] = r + np.arange(len(j), dtype=np.int32)
            xpid[l, r:r + len(j)] = ps[j, c]
            r += len(j)

    def t(x):
        return torch.as_tensor(x).to(arr.inv_mass.device)

    return NHShardTables(
        num_particles=n, num_tets=int(val.sum()), L=L, S=S, Cs=cs, Eb=eb,
        slot_tets=t(sl_t), slot_irp=t(sl_irp), slot_irv=t(sl_irv),
        slot_valid=t(sl_val), slot_imc=t(sl_imc), linv=t(linv), xw=t(xw),
        owned=t(owned), xpid=t(xpid), inv_mass=t(inv_mass),
    )


def comm_bytes_per_substep(t: NHShardTables) -> int:
    """Bytes each shard sends per substep: its [Eb, 3] f32 buffer at every
    level.  The frame's ownership combine adds 36 N once per frame; the
    dense exchange this replaces moved L x N x 12 per substep."""
    return int(t.L * t.Eb * 12)


@dataclasses.dataclass
class ShardGroup:
    """The consecutive shards [first, first + k) on one device, their
    tables stacked on dim 1 (dim 0 of ``owned``)."""

    device: torch.device
    first: int
    k: int
    tables: NHShardTables


@dataclasses.dataclass
class PlacedTables:
    """``NHShardTables`` placed shard by shard on devices (``place``).
    ``rows[l]`` is level l's count of live exchange rows, its first rows."""

    tables: NHShardTables
    groups: List[ShardGroup]
    rows: List[int]


def place(t: NHShardTables, devices) -> PlacedTables:
    """Put shard s's tables on ``devices[s]`` (S devices, repeats allowed);
    the replicated ``xpid`` and ``inv_mass`` go to every device."""
    if len(devices) != t.S:
        raise ValueError(f"{t.S} shards need {t.S} devices, got {len(devices)}")
    groups = []
    for s, dev in enumerate(devices):
        if groups and groups[-1][0] == dev:
            groups[-1][2] += 1
        else:
            groups.append([dev, s, 1])
    out = []
    for dev, first, k in groups:
        cut = slice(first, first + k)

        def put(x, dim=1):
            return (x[:, cut] if dim == 1 else x[cut]).contiguous().to(dev)

        out.append(ShardGroup(dev, first, k, dataclasses.replace(
            t, slot_tets=put(t.slot_tets), slot_irp=put(t.slot_irp),
            slot_irv=put(t.slot_irv), slot_valid=put(t.slot_valid),
            slot_imc=put(t.slot_imc), linv=put(t.linv), xw=put(t.xw),
            owned=put(t.owned, 0), xpid=t.xpid.to(dev),
            inv_mass=t.inv_mass.to(dev))))
    rows = (t.xpid < t.num_particles).sum(dim=1).tolist()
    return PlacedTables(t, out, rows)


def _gather_rows(x, idx):
    """x [..., k, R, 3] at rows idx [k, J] per shard: [..., k, J, 3]."""
    i = idx.long()[..., None].expand(*x.shape[:-3], *idx.shape, 3)
    return torch.gather(x, -2, i)


def _project(pos, p: PlacedTables, dt, params: PhysicsParams):
    """The coloured GS sweep of every shard, with the compact exchange per
    level.  pos: per group [..., k, N, 3].  Returns (pos, the sum over
    shards of det F - 1 over valid tets [...])."""
    t = p.tables
    vol = [None] * len(p.groups)
    for l in range(t.L):
        sums = []
        for gi, g in enumerate(p.groups):
            tb = g.tables
            ids = tb.slot_tets[l]  # [k, Cs, 4]
            pc = _gather_rows(pos[gi], ids.reshape(g.k, -1))
            pc = pc.reshape(*pc.shape[:-2], t.Cs, 4, 3)
            delta, verr = solve_tet_batch(pc, tb.slot_irp[l], tb.slot_irv[l],
                                          tb.slot_imc[l], dt, params)
            valid = tb.slot_valid[l]  # [k, Cs]
            delta = torch.where(valid[:, :, None, None], delta, 0.0)
            newc = (pc + delta).flatten(-3, -2)  # [..., k, Cs*4, 3]
            # local apply: scatter as gather through the shard's inverse
            linv = tb.linv[l]  # [k, N]
            mine = _gather_rows(newc, linv.clamp(min=0))
            pos[gi] = torch.where((linv >= 0)[..., None], mine, pos[gi])
            # the compact buffer, one writer per row (row Eb takes the
            # corners on no shared particle), summed over the group
            xw = tb.xw[l].reshape(g.k, -1).long()[..., None]
            u = newc.new_zeros(*newc.shape[:-2], t.Eb + 1, 3).scatter_(
                -2, xw.expand(*newc.shape[:-3], *xw.shape[:-1], 3), newc)
            sums.append(u[..., :t.Eb, :].sum(dim=-3))
            err = torch.where(valid, verr, 0.0).sum(dim=-1)  # [..., k]
            vol[gi] = err if vol[gi] is None else vol[gi] + err
        n = p.rows[l]
        for gi, g in enumerate(p.groups):
            total = sums[0].to(g.device)
            for other in sums[1:]:
                total = total + other.to(g.device)
            xp = g.tables.xpid[l, :n].long()
            pos[gi][..., xp, :] = total[..., None, :n, :]
    return pos, vol


def step_frame(state: SimState, p: PlacedTables, params: PhysicsParams,
               controls: Controls):
    """One frame of the sharded engine (the engine step contract) on the
    whole state: pos [N, 3] with one body's controls, or a batch pos
    [..., N, 3] with grab_id [..., G] and grab_pos [..., G, 3].  Each shard
    steps its own copy; the frame ends with the ownership combine, and the
    state comes back on its own device, as the unsharded engine gives it.
    Returns (state, vol_errs [..., num_substeps]): per substep the mean
    det F - 1 over the mesh's tets."""
    t = p.tables
    home = state.pos.device
    dt = params.dt
    if state.pos.ndim == 2:
        grab_id, grab_pos = common.norm_grabs(controls)
    else:
        grab_id, grab_pos = controls.grab_id, controls.grab_pos

    def copies(x, g):
        x = x.to(g.device)
        return x.unsqueeze(-3).expand(*x.shape[:-2], g.k, *x.shape[-2:]).clone()

    pos = [copies(state.pos, g) for g in p.groups]
    vel = [copies(state.vel, g) for g in p.groups]
    prev = list(pos)
    grabs = [(grab_id.to(g.device)[..., None, :],
              grab_pos.to(g.device)[..., None, :, :]) for g in p.groups]
    errs = []
    for _ in range(params.num_substeps):
        for gi, g in enumerate(p.groups):
            pos[gi], prev[gi], vel[gi] = common.predict(
                pos[gi], vel[gi], dt, params, inv_mass=g.tables.inv_mass)
        pos, vol = _project(pos, p, dt, params)
        for gi in range(len(p.groups)):
            pos[gi] = common.collide(pos[gi], prev[gi], dt, params)
            pos[gi] = common.grab_override(pos[gi], *grabs[gi])
            vel[gi] = common.velocity_update(pos[gi], prev[gi], dt)
        total = torch.cat([v.to(home) for v in vol], dim=-1).sum(dim=-1)
        errs.append(total / t.num_tets)

    def combine(xs):
        out = None
        for x, g in zip(xs, p.groups):
            mine = torch.where(g.tables.owned[..., None], x, 0.0).sum(dim=-3)
            out = mine.to(home) if out is None else out + mine.to(home)
        return out

    state = state.replace(pos=combine(pos), prev_pos=combine(prev),
                          vel=combine(vel))
    return state, torch.stack(errs, dim=-1)
