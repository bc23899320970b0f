"""Sharding of the polar and Neo-Hookean engines over a device mesh
(counterpart of ``tetsim_tpu/parallel/sharding.py``).

``DeviceMesh`` holds devices on named axes in one process, as a
``jax.sharding.Mesh`` does; a device may repeat, so one card can hold
several shards.  ``make_sharded_step`` scales the engines two ways,
composable on one two-axis mesh:

  * **body axis** - a batch of independent bodies, split into one
    contiguous share per device; each device steps its share with the
    engine's batched frame (``gs_fused.gs_frame`` / ``polar_fused.
    polar_frame``, one launch of K1 / K2 on a card).  Nothing passes
    between devices.
  * **tet axis** - one mesh's tets split over devices:

      - ``polar``: the tets in contiguous chunks; each shard forms its
        tets' rest-volume-weighted goal deltas and sums them per particle
        in plain torch (the JAX package runs this in XLA); the shards'
        sums are added in shard order on every device once per Jacobi
        solve (JAX's ``psum``), and each device moves its copy of the
        particles by them;
      - ``neohookean``: RCB shards with a compact per-level exchange
        (``nh_shard``).

The step takes and returns the whole state on its own device, as the
unsharded engine does: what each device needs of it moves there and back
inside the step.  ``prepare`` pads and places the tables once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..mesh import TetArrays, build_incidence
from ..params import PhysicsParams
from ..solvers import common, polar
from ..state import Controls, SimState, check_device
from . import nh_shard

ENGINES = ("polar", "neohookean")


class DeviceMesh:
    """Devices on named axes: ``DeviceMesh(["cuda"] * 4, "body")`` puts 4
    body shares on the card, ``DeviceMesh([["cpu"] * 2] * 4, ("body",
    "tet"))`` a 4 x 2 grid on the CPU.  ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(names) or grid.size == 0:
            raise ValueError(f"devices of shape {grid.shape} do not fit the "
                             f"axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        self.axis_names = names
        self.devices = np.vectorize(check_device, otypes=[object])(grid)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, **index) -> torch.device:
        """The device at the given index of each named axis (0 for an axis
        left out)."""
        unknown = set(index) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axis {sorted(unknown)} in {self.axis_names}")
        return self.devices[tuple(index.get(n, 0) for n in self.axis_names)]

    def axis_devices(self, axis) -> List[torch.device]:
        """The devices along ``axis`` (a name, or a tuple of names read in
        that order, first name slowest), index 0 on every other axis."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axis {sorted(unknown)} in {self.axis_names}")
        sub = self.devices[tuple(slice(None) if n in names else 0
                                 for n in self.axis_names)]
        kept = [n for n in self.axis_names if n in names]
        return list(sub.transpose([kept.index(n) for n in names]).reshape(-1))


# ---------------------------------------------------------------------------
# Padding (a shard axis must divide evenly)
# ---------------------------------------------------------------------------


def _pad_dim(x, dim: int, pad: int):
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def pad_tet_arrays(arr: TetArrays, k: int) -> TetArrays:
    """Pad the tet dimension to a multiple of k with degenerate tets: all
    four corners on particle 0, zero rest volume and rest pose.  They give
    the polar sums zero weight and no GS slot lists them, so they change
    neither engine's numbers."""
    pad = (-arr.num_tets) % k
    if pad == 0:
        return arr
    return dataclasses.replace(arr, **{
        f: _pad_dim(getattr(arr, f), 0, pad)
        for f in ("tets", "inv_rest_pose", "inv_rest_volume", "rest_volume",
                  "rest_centered")})


def pad_slots(arr: TetArrays, k: int) -> TetArrays:
    """Pad the GS schedule's slot columns to a multiple of k with invalid
    (masked) slots."""
    pad = (-int(arr.slot_tets.shape[1])) % k
    if pad == 0:
        return arr
    return dataclasses.replace(arr, **{
        f: _pad_dim(getattr(arr, f), 1, pad)
        for f in ("slot_tets", "slot_inv_rest_pose", "slot_inv_rest_volume",
                  "slot_valid", "slot_inv_mass")})


def pad_quats(state: SimState, k: int) -> SimState:
    """Pad the per-tet quaternions [..., M, 4] to a multiple of k with
    identity quaternions."""
    pad = (-int(state.quats.shape[-2])) % k
    if pad == 0:
        return state
    q = _pad_dim(state.quats, -2, pad)
    q[..., -pad:, 3] = 1.0
    return state.replace(quats=q)


# ---------------------------------------------------------------------------
# Batches of bodies
# ---------------------------------------------------------------------------


def batch_state(state: SimState, n: int, jitter: float = 0.0,
                seed: int = 0) -> SimState:
    """n copies of a one-body state as a batch [n, ...].  ``jitter``
    offsets each body by a seeded random translation (y kept
    non-negative), drawn as ``FusedBatch`` draws its jitter (numpy's
    RandomState; the JAX package draws with ``jax.random``, so its offsets
    differ)."""
    def tile(x):
        return x.unsqueeze(0).repeat(n, *([1] * x.ndim))

    batched = SimState(*(tile(x) for x in (state.pos, state.prev_pos,
                                           state.vel, state.quats)))
    if jitter:
        rng = np.random.RandomState(seed)
        off = rng.uniform(-jitter, jitter, (n, 1, 3)).astype(np.float32)
        off[..., 1] = np.abs(off[..., 1])  # keep above ground
        off = torch.as_tensor(off).to(state.pos.device)
        batched = batched.replace(pos=batched.pos + off,
                                  prev_pos=batched.prev_pos + off)
    return batched


def batch_controls(n: int, device) -> Controls:
    """No grab on any of n bodies: grab_id [n] of -1, grab_pos [n, 3]."""
    return Controls(
        grab_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        grab_pos=torch.zeros((n, 3), dtype=torch.float32, device=device),
    )


def _grabs(controls: Controls, batched: bool):
    """(grab_id [..., G], grab_pos [..., G, 3]): one body's controls as
    ``common.norm_grabs`` gives them, a batch's [B] or [B, G] ids with
    [B, 3] or [B, G, 3] targets."""
    if not batched:
        return common.norm_grabs(controls)
    gid = torch.as_tensor(controls.grab_id).to(torch.int32)
    gpos = torch.as_tensor(controls.grab_pos, dtype=torch.float32)
    if gid.ndim == 1:
        gid, gpos = gid[:, None], gpos[:, None, :]
    return gid, gpos


# ---------------------------------------------------------------------------
# Tables placed on the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshTables:
    """What ``prepare`` places for ``make_sharded_step``: per share of the
    body axis (one share without it), the tables of its tet shards.
    Without a tet axis, a ``TetArrays`` on the share's device.  On the
    polar tet axis, a list with shard j's contiguous chunk of the padded
    tets as ``TetArrays`` on its device, with its own incidence table
    (chunk-local corner ids) and, shared by all, the particles' inverse
    masses and whole rest-volume sums (``inc_den``: static, so added
    once).  On the Neo-Hookean tet axis, ``nh_shard.PlacedTables``."""

    engine: str
    tet_axis: Optional[str]
    body_axis: Optional[str]
    shares: list


def _share_devices(mesh: DeviceMesh, tet_axis, body_axis):
    """For each share of the body axis, its devices along the tet axis."""
    def at(i, j):
        return mesh.device(**{a: k for a, k in ((body_axis, i), (tet_axis, j))
                              if a is not None})

    nb = mesh.shape[body_axis] if body_axis is not None else 1
    nt = mesh.shape[tet_axis] if tet_axis is not None else 1
    return [[at(i, j) for j in range(nt)] for i in range(nb)]


def _with_incidence(arr: TetArrays) -> TetArrays:
    """``arr`` with the polar engine's incidence tables, built on the host
    where it has none (the polar frame kernel reads them)."""
    if arr.inc_idx is not None:
        return arr
    inc, den = build_incidence(arr.tets.cpu().numpy(),
                               arr.rest_volume.cpu().numpy(),
                               arr.num_particles)
    dev = arr.inv_mass.device
    return dataclasses.replace(arr, inc_idx=torch.as_tensor(inc).to(dev),
                               inc_den=torch.as_tensor(den).to(dev))


def _polar_shards(arr: TetArrays, devices) -> List[TetArrays]:
    m = arr.num_tets // len(devices)
    den = _with_incidence(arr).inc_den
    out = []
    for j, dev in enumerate(devices):
        cut = slice(j * m, (j + 1) * m)
        chunk = {f: getattr(arr, f)[cut] for f in (
            "tets", "inv_rest_pose", "inv_rest_volume", "rest_volume",
            "rest_centered")}
        inc, _ = build_incidence(chunk["tets"].cpu().numpy(),
                                 chunk["rest_volume"].cpu().numpy(),
                                 arr.num_particles)
        out.append(TetArrays(inv_mass=arr.inv_mass, inc_den=den,
                             inc_idx=torch.as_tensor(inc), **chunk).to(dev))
    return out


def prepare(state: SimState, arr: TetArrays, mesh: DeviceMesh,
            engine: str = "polar", tet_axis: Optional[str] = "tet",
            body_axis: Optional[str] = None):
    """Pad ``state`` and place ``arr`` for ``make_sharded_step`` on this
    mesh.  Returns (state, tables): the state on its own device (the polar
    tet axis pads its quaternions to whole shards), and the ``MeshTables``
    the step reads.  For ``neohookean`` with a tet axis the GS schedule is
    regrouped into ``nh_shard`` tables, partitioned at the state's
    positions (the first body's, in a batch)."""
    if engine not in ENGINES:
        raise ValueError(f"sharded engines are {ENGINES}, not {engine!r}")
    rows = _share_devices(mesh, tet_axis, body_axis)
    if tet_axis is None:
        arr = _with_incidence(arr) if engine == "polar" else arr
        shares = [arr.to(row[0]) for row in rows]
    elif engine == "polar":
        k = mesh.shape[tet_axis]
        arr = pad_tet_arrays(arr, k)
        state = pad_quats(state, k)
        shares = [_polar_shards(arr, row) for row in rows]
    else:
        pos0 = state.pos.cpu().numpy()
        if pos0.ndim == 3:  # a batch: every body has the same mesh
            pos0 = pos0[0]
        t = nh_shard.build_nh_shard_tables(arr, pos0, mesh.shape[tet_axis])
        shares = [nh_shard.place(t, row) for row in rows]
    return state, MeshTables(engine, tet_axis, body_axis, shares)


# ---------------------------------------------------------------------------
# The frames of one share
# ---------------------------------------------------------------------------


def _fused_frame(engine, state: SimState, arr: TetArrays,
                 params: PhysicsParams, gid, gpos):
    """A share of b bodies (pos [b, N, 3]) through the engine's batched
    frame on ``arr``'s device: the plain frame on the CPU, one launch of
    the fused kernel on a card.  Returns (state, diag [b, S]) on the
    state's device."""
    from ..kernels import gs_fused, polar_fused

    home, dev = state.pos.device, arr.inv_mass.device
    pos, vel, gid, gpos = (x.to(dev) for x in (state.pos, state.vel, gid, gpos))
    if engine == "neohookean":
        pos, prev, vel, diag = gs_fused.gs_frame(pos, vel, arr, params, gid,
                                                 gpos)
        quats = state.quats
    else:
        pos, prev, vel, quats = polar_fused.polar_frame(
            pos, vel, state.quats.to(dev), arr, params, gid, gpos)
        diag = pos.new_zeros((pos.shape[0], params.num_substeps))
    out = state.replace(pos=pos.to(home), prev_pos=prev.to(home),
                        vel=vel.to(home), quats=quats.to(home))
    return out, diag.to(home)


def _polar_tet_frame(state: SimState, shards: List[TetArrays],
                     params: PhysicsParams, gid, gpos):
    """One polar frame with the tets split over shards (pos [..., N, 3]).
    Each device keeps one copy of the particles; per Jacobi solve every
    shard sums its tets' weighted goal deltas per particle, and every
    device adds the shards' sums in shard order, so each copy moves by the
    same bits.  Returns (state, zeros [..., S]) on the state's device."""
    home = state.pos.device
    devs = [a.inv_mass.device for a in shards]
    m = shards[0].num_tets
    quats = [state.quats[..., j * m:(j + 1) * m, :].to(dev)
             for j, dev in enumerate(devs)]
    here = list(dict.fromkeys(devs))  # one copy per device, in shard order
    first = {d: devs.index(d) for d in here}
    pos = {d: state.pos.to(d) for d in here}
    vel = {d: state.vel.to(d) for d in here}
    prev = dict(pos)
    grabs = {d: (gid.to(d), gpos.to(d)) for d in here}
    dt = params.dt
    for _ in range(params.num_substeps):
        for d in here:
            pos[d], prev[d], vel[d] = common.predict(
                pos[d], vel[d], dt, params, inv_mass=shards[first[d]].inv_mass)
        sums = []
        for j, (a, dev) in enumerate(zip(shards, devs)):
            weighted, quats[j] = polar.goal_deltas(pos[dev], quats[j], a,
                                                   params.extract_iters)
            sums.append(polar.particle_sums(weighted, pos[dev], a)[0])
        for d in here:
            num = sums[0].to(d)
            for s in sums[1:]:
                num = num + s.to(d)
            a = shards[first[d]]
            x = polar.move_to_goals(pos[d], num, a.inc_den, a.inv_mass)
            x = common.collide(x, prev[d], dt, params)
            pos[d] = common.grab_override(x, *grabs[d])
            vel[d] = common.velocity_update(pos[d], prev[d], dt)
    d = here[0]
    out = state.replace(pos=pos[d].to(home), prev_pos=prev[d].to(home),
                        vel=vel[d].to(home),
                        quats=torch.cat([q.to(home) for q in quats], dim=-2))
    return out, out.pos.new_zeros((*out.pos.shape[:-2], params.num_substeps))


def make_sharded_step(mesh: DeviceMesh, engine: str = "polar",
                      tet_axis: Optional[str] = "tet",
                      body_axis: Optional[str] = None):
    """``(state, tables, params, controls) -> (state, diags)`` over a
    device mesh, ``tables`` from ``prepare`` on the same mesh and axes.

    ``tet_axis`` / ``body_axis`` name mesh axes, or None to leave that
    dimension unsharded.  With ``body_axis`` the state and controls carry a
    leading batch dimension (``batch_state``, ``batch_controls``), split
    evenly over that axis, and diags is [B, num_substeps]; without it
    [num_substeps].  The returned state is whole and on the input state's
    device; on CUDA devices every kernel launches or raises."""
    if engine not in ENGINES:
        raise ValueError(f"sharded engines are {ENGINES}, not {engine!r}")
    for axis in (tet_axis, body_axis):
        if axis is not None and axis not in mesh.axis_names:
            raise ValueError(f"no axis {axis!r} in {mesh.axis_names}")

    def share_frame(state, tables, params, gid, gpos):
        if tet_axis is None:
            return _fused_frame(engine, state, tables, params, gid, gpos)
        if engine == "polar":
            return _polar_tet_frame(state, tables, params, gid, gpos)
        return nh_shard.step_frame(state, tables, params,
                                   Controls(gid, gpos))

    def step(state: SimState, tables: MeshTables, params: PhysicsParams,
             controls: Controls):
        if (tables.engine, tables.tet_axis, tables.body_axis) != (
                engine, tet_axis, body_axis):
            raise ValueError(
                "tables were prepared for engine/tet_axis/body_axis "
                f"{(tables.engine, tables.tet_axis, tables.body_axis)}, not "
                f"{(engine, tet_axis, body_axis)}")
        batched = body_axis is not None
        gid, gpos = _grabs(controls, batched)
        home = state.pos.device
        fields = [state.pos, state.prev_pos, state.vel, state.quats]
        gid, gpos = gid.to(home), gpos.to(home)
        if not batched:  # a batch of one body, one share
            fields, gid, gpos = [x[None] for x in fields], gid[None], gpos[None]
        n, d = fields[0].shape[0], len(tables.shares)
        if n % d:
            raise ValueError(f"batch of {n} bodies must split evenly across "
                             f"{d} devices")
        b = n // d
        outs = [share_frame(SimState(*(x[i * b:(i + 1) * b] for x in fields)),
                            share, params, gid[i * b:(i + 1) * b],
                            gpos[i * b:(i + 1) * b])
                for i, share in enumerate(tables.shares)]
        joined = [torch.cat([getattr(s, f) for s, _ in outs])
                  for f in ("pos", "prev_pos", "vel", "quats")]
        diags = torch.cat([dg for _, dg in outs])
        if not batched:
            joined, diags = [x[0] for x in joined], diags[0]
        return SimState(*joined), diags

    return step
