"""What the fused frame kernels share: the argument checks of their
wrappers, the per-launch host work they do once (``cached_params``,
``prepared``), and ``FusedBatch``, the state and per-body grab API of B
bodies of one mesh (the base of ``FusedGSBody`` and ``FusedPolarBody``)."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh import TetMesh
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


class FusedBatch:
    """B bodies of one mesh: pos/prev_pos/vel [B,N,3] on ``device`` and one
    grab per body (grab_id int32 [B,1], -1 inactive; grab_pos [B,1,3]).
    ``jitter`` offsets each body by a seeded random translation (y kept
    non-negative), drawn as the JAX package draws it."""

    def __init__(self, mesh: TetMesh, num_bodies: int, jitter: float,
                 seed: int, device):
        self.mesh = mesh
        self.num_bodies = num_bodies
        self.device = check_device(device)
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

    # -- views ---------------------------------------------------------------
    def positions(self) -> np.ndarray:
        """[num_bodies, N, 3] current particle positions."""
        return self.pos.cpu().numpy()

    def velocities(self) -> np.ndarray:
        return self.vel.cpu().numpy()

    def summary(self) -> dict:
        """Batch size, lowest particle, fastest particle and NaN flag, in
        one device-to-host transfer."""
        h = torch.stack([
            self.pos[..., 1].min(),
            torch.linalg.vector_norm(self.vel, dim=-1).max(),
            torch.isnan(self.pos).any().to(torch.float32),
        ]).tolist()
        return {"batch": self.num_bodies, "min_height": h[0],
                "max_speed": h[1], "nan": bool(h[2])}

    # -- interaction ---------------------------------------------------------
    def _check_body(self, body: int):
        if not 0 <= body < self.num_bodies:
            raise IndexError(
                f"body index {body} out of range (batch has {self.num_bodies})"
            )

    def _point(self, point) -> torch.Tensor:
        return torch.as_tensor(np.asarray(point, np.float32)).to(self.device)

    def set_grab(self, body: int, particle: int, point):
        self._check_body(body)
        self.grab_id[body, 0] = particle
        self.grab_pos[body, 0] = self._point(point)

    def start_grab(self, body: int, point) -> int:
        """Grab the body's particle nearest to ``point``; returns its id."""
        self._check_body(body)
        p = self._point(point)
        pid = int(torch.argmin(((self.pos[body] - p) ** 2).sum(dim=-1)))
        self.set_grab(body, pid, point)
        return pid

    def move_grabbed(self, body: int, point):
        self._check_body(body)
        self.grab_pos[body, 0] = self._point(point)

    def end_grab(self, body: int):
        self._check_body(body)
        self.grab_id[body, 0] = -1
