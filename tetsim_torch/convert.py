"""Carry parameters, state and mesh tables across from numpy, so a run of
the JAX package can be handed to this one mid-trajectory:

    params = params_from_numpy({f.name: np.asarray(getattr(p, f.name))
                                for f in dataclasses.fields(p)})
    state = state_from_numpy(*(np.asarray(x) for x in
                               (s.pos, s.prev_pos, s.vel, s.quats)), device)
    arrays = arrays_from_numpy(device, **{k: np.asarray(v) for k, v in ...})

Every helper takes the device from its caller.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import TetArrays
from .params import PhysicsParams
from .state import SimState


def params_from_numpy(fields: dict) -> PhysicsParams:
    """PhysicsParams from its fields as numpy scalars or arrays; unknown
    names raise."""
    known = {f.name for f in dataclasses.fields(PhysicsParams)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown PhysicsParams fields: {sorted(unknown)}")
    kw = {}
    for k, v in fields.items():
        v = np.asarray(v)
        kw[k] = int(v) if k in ("num_substeps", "extract_iters") else v.astype(np.float32)
    return PhysicsParams(**kw)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32)).to(device)  # a writable copy


def state_from_numpy(pos, prev_pos, vel, quats, device) -> SimState:
    return SimState(pos=_f32(pos, device), prev_pos=_f32(prev_pos, device),
                    vel=_f32(vel, device), quats=_f32(quats, device))


def arrays_from_numpy(device, **fields) -> TetArrays:
    """TetArrays from numpy arrays named as its fields; absent or None
    fields stay None, and fields TetArrays does not have raise."""
    known = {f.name for f in dataclasses.fields(TetArrays)}
    unknown = {k for k, v in fields.items() if v is not None} - known
    if unknown:
        raise ValueError(f"unknown TetArrays fields: {sorted(unknown)}")
    return TetArrays(**{
        k: None if fields.get(k) is None
        else torch.as_tensor(np.array(fields[k])).to(device)
        for k in known
    })
