"""Simulation state (counterpart of ``tetsim_tpu/state.py``).

Plain dataclasses of tensors on one device.  The solvers return new state
objects and leave their inputs untouched, like the JAX package's pure
functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import TetMesh


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises where it names CUDA and CUDA is
    not available (no silent CPU fallback) or names neither CPU nor CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tetsim_torch runs on cpu or cuda, not {dev}")
    return dev


@dataclasses.dataclass
class SimState:
    pos: torch.Tensor  # f32 [N,3]
    prev_pos: torch.Tensor  # f32 [N,3]
    vel: torch.Tensor  # f32 [N,3]
    quats: torch.Tensor  # f32 [M,4] per-tet rotation (polar path; xyzw)

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Controls:
    """Per-step interaction inputs.  ``grab_id`` is an int32 scalar (one
    grab) or [G] (G simultaneous grabs) with ``grab_pos`` [3] or [G,3];
    a negative id is inactive."""

    grab_id: torch.Tensor
    grab_pos: torch.Tensor

    @staticmethod
    def none(device) -> "Controls":
        return Controls(
            grab_id=torch.tensor(-1, dtype=torch.int32, device=device),
            grab_pos=torch.zeros(3, dtype=torch.float32, device=device),
        )

    def replace(self, **changes) -> "Controls":
        return dataclasses.replace(self, **changes)


def init_state(mesh: TetMesh, device) -> SimState:
    pos = torch.tensor(np.asarray(mesh.verts, np.float32), device=device)
    quats = torch.zeros((mesh.num_tets, 4), dtype=torch.float32, device=device)
    quats[:, 3] = 1.0
    return SimState(pos=pos, prev_pos=pos.clone(), vel=torch.zeros_like(pos),
                    quats=quats)
