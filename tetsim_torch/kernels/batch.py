"""What the fused frame kernels share: the argument checks of their
wrappers, the per-launch host work they do once (``cached_params``,
``prepared``), and ``FusedBatch``, the state and per-body grab API of B
bodies of one mesh (the base of ``FusedGSBody`` and ``FusedPolarBody``),
with its split over the devices of a mesh axis (their ``shard``)."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh import TetMesh
from ..spans import GRAB_END, GRAB_MOVE, GRAB_START, span
from ..state import check_device

SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (227 KB)

_params_cache: dict = {}  # (build function, parameter values) -> struct


def cached_params(params, build):
    """``build(params)``, a kernel's struct of frame scalars, made once per
    build function and set of parameter values (``PhysicsParams`` is
    mutable, so the key is its values, not the object)."""
    key = (build, params.gravity, params.time_scale, params.time_step,
           params.friction, params.dev_compliance, params.vol_compliance,
           params.num_substeps, params.extract_iters,
           params.world_min.tobytes(), params.world_max.tobytes())
    hit = _params_cache.get(key)
    if hit is None:
        if len(_params_cache) >= 64:
            _params_cache.clear()
        hit = _params_cache[key] = build(params)
    return hit


def prepared(lib, name: str, device, n: int) -> int:
    """Calls ``lib.<name>_prepare(n)``, which sets the kernel's function
    attributes on the current device for bodies of up to n particles (the
    largest dynamic shared memory it may take, one value per kernel), once
    per library and device and again only for a larger n; returns its CUDA
    error (0 = set, now or before)."""
    largest = lib.__dict__.setdefault("prepared", {})
    if largest.get(device.index, -1) >= n:
        return 0
    err = getattr(lib, f"{name}_prepare")(n)
    if err == 0:
        largest[device.index] = n
    return err


def expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {list(shape)} on {device}, got "
            f"{t.dtype} {list(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class BodyField:
    """A tensor of a ``FusedBatch`` indexed by body on dim 0, held as one
    tensor per part of the batch (``FusedBatch.shard``): read, it is the
    parts joined in body order on the batch's device (the one tensor itself
    while the batch is whole); written, it is split into the parts, each
    moved to its part's device.  None stays None."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, batch, owner=None):
        if batch is None:
            return self
        parts = batch._fields[self.name]
        if len(parts) == 1 or parts[0] is None:
            return parts[0]
        return torch.cat([p.to(batch.device) for p in parts])

    def __set__(self, batch, value):
        batch._fields[self.name] = [
            value if value is None or len(batch.parts) == 1
            else value[lo:hi].to(dev)
            for dev, lo, hi in batch.parts]


class FusedBatch:
    """B bodies of one mesh: pos/prev_pos/vel [B,N,3] on ``device`` and one
    grab per body (grab_id int32 [B,1], -1 inactive; grab_pos [B,1,3]).
    ``jitter`` offsets each body by a seeded random translation (y kept
    non-negative), drawn as the JAX package draws it.

    ``parts`` lists (device, first body, end) of each contiguous sub-batch:
    one part on ``device`` until ``shard`` splits the batch over the devices
    of a mesh axis.  The body-indexed tensors are ``BodyField``s, so the
    views, the grabs and the scene checkpoint read and write the whole
    batch in body order either way."""

    pos = BodyField()
    prev_pos = BodyField()
    vel = BodyField()
    grab_id = BodyField()
    grab_pos = BodyField()

    def __init__(self, mesh: TetMesh, num_bodies: int, jitter: float,
                 seed: int, device):
        self.mesh = mesh
        self.num_bodies = num_bodies
        self.device = check_device(device)
        self.parts = [(self.device, 0, num_bodies)]
        self._fields: dict = {}
        self._part_arrays = None  # the tables on each part's device
        verts = np.repeat(mesh.verts.astype(np.float32)[None], num_bodies, axis=0)
        if jitter:
            rng = np.random.RandomState(seed)
            off = rng.uniform(-jitter, jitter, (num_bodies, 3)).astype(np.float32)
            off[:, 1] = np.abs(off[:, 1])  # keep above ground
            verts = verts + off[:, None, :]
        self.pos = torch.as_tensor(verts).to(self.device)
        self.prev_pos = self.pos.clone()
        self.vel = torch.zeros_like(self.pos)
        self.grab_id = torch.full((num_bodies, 1), -1, dtype=torch.int32,
                                  device=self.device)
        self.grab_pos = torch.zeros((num_bodies, 1, 3), dtype=torch.float32,
                                    device=self.device)

    # -- sharding over devices -------------------------------------------------
    def _shard(self, mesh, axis):
        """Split the batch into one contiguous sub-batch per device of
        ``mesh``'s ``axis`` (a name or a tuple of names; a device may
        repeat), with ``self.arrays`` replicated on each device."""
        devices = mesh.axis_devices(axis)
        d = len(devices)
        if self.num_bodies % d:
            raise ValueError(
                f"batch of {self.num_bodies} bodies must split evenly across "
                f"{d} devices; pad num_bodies")
        whole = {name: getattr(self, name) for name in self._fields}
        b = self.num_bodies // d
        self.parts = [(dev, i * b, (i + 1) * b) for i, dev in enumerate(devices)]
        for name, value in whole.items():
            setattr(self, name, value)
        self._part_arrays = [self.arrays.to(dev) for dev in devices]
        return self

    def _step_parts(self, frame, params, ins, outs):
        """One frame of every part: ``frame(*ins, arrays, params, grab_id,
        grab_pos)`` on the part's tensors and tables, its results stored as
        the part's ``outs``.  Each part's launch goes to its device's
        current stream; nothing waits for the host."""
        f = self._fields
        for i, arrays in enumerate(self._part_arrays or [self.arrays]):
            res = frame(*(f[n][i] for n in ins), arrays, params,
                        f["grab_id"][i], f["grab_pos"][i])
            for n, r in zip(outs, res):
                f[n][i] = r

    def _locate(self, body: int):
        """(part, body within the part) of a body index."""
        if not 0 <= body < self.num_bodies:
            raise IndexError(
                f"body index {body} out of range (batch has {self.num_bodies})"
            )
        for i, (_, lo, hi) in enumerate(self.parts):
            if lo <= body < hi:
                return i, body - lo

    # -- views ---------------------------------------------------------------
    def positions(self) -> np.ndarray:
        """[num_bodies, N, 3] current particle positions."""
        return self.pos.cpu().numpy()

    def velocities(self) -> np.ndarray:
        return self.vel.cpu().numpy()

    def summary(self) -> dict:
        """Batch size, lowest particle, fastest particle and NaN flag, in
        one device-to-host transfer."""
        pos, vel = self.pos, self.vel
        h = torch.stack([
            pos[..., 1].min(),
            torch.linalg.vector_norm(vel, dim=-1).max(),
            torch.isnan(pos).any().to(torch.float32),
        ]).tolist()
        return {"batch": self.num_bodies, "min_height": h[0],
                "max_speed": h[1], "nan": bool(h[2])}

    # -- interaction ---------------------------------------------------------
    def _grab_slot(self, body: int):
        """The part's grab_id and grab_pos rows of a body."""
        i, k = self._locate(body)
        return self._fields["grab_id"][i][k], self._fields["grab_pos"][i][k]

    def _point(self, point, like) -> torch.Tensor:
        return torch.as_tensor(np.asarray(point, np.float32)).to(like.device)

    def set_grab(self, body: int, particle: int, point):
        with span(GRAB_START):
            gid, gpos = self._grab_slot(body)
            gid[0] = particle
            gpos[0] = self._point(point, gpos)

    def start_grab(self, body: int, point) -> int:
        """Grab the body's particle nearest to ``point``; returns its id."""
        with span(GRAB_START):
            i, k = self._locate(body)
            pos = self._fields["pos"][i][k]
            pid = int(torch.argmin(
                ((pos - self._point(point, pos)) ** 2).sum(dim=-1)))
            self.set_grab(body, pid, point)
            return pid

    def move_grabbed(self, body: int, point):
        with span(GRAB_MOVE):
            _, gpos = self._grab_slot(body)
            gpos[0] = self._point(point, gpos)

    def end_grab(self, body: int):
        with span(GRAB_END):
            gid, _ = self._grab_slot(body)
            gid[0] = -1
