"""Scenes over tetsim_torch's World API, as the cells drive them.

A scene holds one World and the body the traffic drives, and offers the
calls of the two loops in ``loop.py``: ``dispatch`` (frames enqueued with
no host sync), ``token`` (a data-dependent reduction the host reads),
``capture`` (the positions and velocities [B, N, 3] on the device, for the
comparison with the reference), and for one body ``step_export`` and the
grab calls.  The configurations' builders (``configs/<config>.py``) make
them; tetsim_torch is imported only when a scene is built.
"""
from __future__ import annotations

import numpy as np
import torch

PHYSICS_KEYS = ("gravity", "time_scale", "time_step", "friction", "density",
                "dev_compliance", "vol_compliance", "world_min", "world_max",
                "num_substeps")


def physics(config: dict):
    """The configuration's physics parameters as the port's dataclass."""
    from tetsim_torch import PhysicsParams

    return PhysicsParams(**{k: config[k] for k in PHYSICS_KEYS})


def program_seed(seed: int) -> int:
    """The seed handed to the port, whose jitter is drawn with numpy's
    RandomState (seeds below 2**32)."""
    return int(seed) % 2**32


class Scene:
    """A World with the body that the traffic drives."""

    def __init__(self, world, body, bodies: int):
        self.world = world
        self.body = body
        self.bodies = bodies
        self.params = world.params
        self.substeps = int(world.params.num_substeps)

    def dispatch(self, frames: int) -> None:
        self.world.step(frames)

    def capture(self):
        raise NotImplementedError

    def token(self) -> torch.Tensor:
        """[2] on the device: the sum of every position and 1 where every
        position and velocity is finite (0 else)."""
        pos, vel = self.capture()
        ok = torch.isfinite(pos).all() & torch.isfinite(vel).all()
        return torch.stack([pos.sum(), ok.to(pos.dtype)])


class BatchScene(Scene):
    """``World.add_body_batch``: B bodies of one mesh."""

    def capture(self):
        return self.body.pos, self.body.vel


class BodyScene(Scene):
    """``World.add_body``: one body, with the viewer's export and grab."""

    def capture(self):
        st = self.body.state
        return st.pos[None], st.vel[None]

    def step_export(self) -> torch.Tensor:
        return self.body.step_many_export(self.params, 1)

    def grab_positions(self) -> torch.Tensor:
        return self.body.state.pos

    def start_grab(self, point) -> int:
        return self.body.start_grab(point)

    def move_grabbed(self, point) -> None:
        self.body.move_grabbed(point)

    def end_grab(self) -> None:
        self.body.end_grab()


class PackedGridScene(BodyScene):
    """``World.add_grid_body(..., packed=True)``: one box whose state stays
    in the grid kernel's layout; ``capture`` converts it (a few small
    device ops, no sync)."""

    def grab_positions(self) -> torch.Tensor:
        return self.body.pos_device()


def seeded_velocities(seed: int, shape, speed: float, device) -> torch.Tensor:
    """f32 ``shape`` uniform in [-speed, speed], drawn on ``device`` by a
    torch.Generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * 2.0 - 1.0) * np.float32(speed)
