"""Physics parameter dataclass (counterpart of ``tetsim_tpu/params.py``).

Same fields and defaults as the reference's ``physicsParams`` config.  The
fields are host values (float32 numpy scalars, float32 [3] arrays for the
world bounds): the solvers pass them to the kernel by value or broadcast
them into tensor arithmetic.  Derived scalars (``dt``, ``gamma``) are
computed in float32 with the same operation order as the JAX package, so
both packages feed bitwise-identical constants to their solvers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32


@dataclasses.dataclass
class PhysicsParams:
    """Tunable physics parameters.  ``num_substeps`` sets the length of the
    substep loop of one frame; the polar engine reads ``extract_iters``,
    the number of extract_rotation iterations per substep."""

    gravity: np.float32 = f32(-9.81)
    time_scale: np.float32 = f32(1.0)
    time_step: np.float32 = f32(1.0 / 60.0)
    friction: np.float32 = f32(1000.0)
    density: np.float32 = f32(1000.0)
    dev_compliance: np.float32 = f32(1.0 / 100000.0)
    vol_compliance: np.float32 = f32(0.0)
    world_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-2.5, -1.0, -2.5], np.float32)
    )
    world_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([2.5, 10.0, 2.5], np.float32)
    )
    num_substeps: int = 5
    extract_iters: int = 9

    def __post_init__(self):
        for name in ("gravity", "time_scale", "time_step", "friction",
                     "density", "dev_compliance", "vol_compliance"):
            setattr(self, name, f32(getattr(self, name)))
        self.world_min = np.asarray(self.world_min, np.float32).reshape(3)
        self.world_max = np.asarray(self.world_max, np.float32).reshape(3)
        self.num_substeps = int(self.num_substeps)
        self.extract_iters = int(self.extract_iters)

    @property
    def dt(self) -> np.float32:
        """Per-substep timestep, f32(time_scale) * f32(time_step) / n."""
        return self.time_scale * self.time_step / f32(self.num_substeps)

    @property
    def gamma(self) -> np.float32:
        """Hydrostatic rest offset vol_compliance / dev_compliance (f32)."""
        return self.vol_compliance / self.dev_compliance


def default_cpu_params() -> PhysicsParams:
    """Parameters matching the reference CPU solver config (?cpu=true)."""
    return PhysicsParams(num_substeps=5)


def default_gpu_params() -> PhysicsParams:
    """Parameters matching the reference GPU solver config."""
    return PhysicsParams(num_substeps=20)
