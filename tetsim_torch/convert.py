"""Carry parameters, state and mesh tables across from numpy, so a run of
the JAX package can be handed to this one mid-trajectory:

    params = params_from_numpy({f.name: np.asarray(getattr(p, f.name))
                                for f in dataclasses.fields(p)})
    state = state_from_numpy(*(np.asarray(x) for x in
                               (s.pos, s.prev_pos, s.vel, s.quats)), device)
    arrays = arrays_from_numpy(device, **{k: np.asarray(v) for k, v in ...})

and a grid body's stencil arrays (``GridArrays``, ``NHGridArrays``) with
``grid_arrays_from_numpy`` / ``nh_grid_arrays_from_numpy``, and a pieces
body's tables (``PiecesArrays``, ``NHPiecesArrays``) with
``pieces_arrays_from_numpy`` / ``nh_pieces_arrays_from_numpy``, their
static fields as they are and their arrays as numpy.  Every helper takes
the device from its caller.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.nh_pieces import NHPiecesArrays, live_counts
from .kernels.polar_pieces import PiecesArrays
from .mesh import TetArrays
from .params import PhysicsParams
from .solvers.neohookean_grid import NHGridArrays
from .solvers.polar_grid import GridArrays
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


def _stencil_arrays(cls, device, fields: dict):
    """A grid or pieces arrays dataclass from its fields: tuples and numbers
    as given (nested sequences become tuples), numpy arrays as tensors of
    their own type on ``device``; missing or unknown fields raise."""
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != names:
        raise ValueError(f"{cls.__name__} fields: expected {sorted(names)}, "
                         f"got {sorted(fields)}")

    def static(v):
        if isinstance(v, (list, tuple)):
            return tuple(static(x) for x in v)
        return int(v) if isinstance(v, (int, np.integer)) else float(v)

    return cls(**{k: torch.as_tensor(np.array(v)).to(device)
                  if isinstance(v, np.ndarray) else static(v)
                  for k, v in fields.items()})


def grid_arrays_from_numpy(device, **fields) -> GridArrays:
    """GridArrays from the JAX package's GridArrays fields (inv_mass and
    den as numpy)."""
    return _stencil_arrays(GridArrays, device, fields)


def nh_grid_arrays_from_numpy(device, **fields) -> NHGridArrays:
    """NHGridArrays from the JAX package's NHGridArrays fields
    (inv_mass_blocks and inv_mass as numpy)."""
    return _stencil_arrays(NHGridArrays, device, fields)


# the JAX package's pieces fields that exist only for Mosaic's tiled gathers
_MOSAIC_FIELDS = ("t_tiles", "gather_tiles", "scatter_tiles")


def pieces_arrays_from_numpy(device, **fields) -> PiecesArrays:
    """PiecesArrays from the JAX package's PiecesArrays fields (arrays as
    numpy); its Mosaic tile lists are dropped."""
    kept = {k: v for k, v in fields.items() if k not in _MOSAIC_FIELDS}
    return _stencil_arrays(PiecesArrays, device, kept)


def nh_pieces_arrays_from_numpy(device, **fields) -> NHPiecesArrays:
    """NHPiecesArrays from the JAX package's NHPiecesArrays fields (arrays
    as numpy); its Mosaic tile lists are dropped, and its inverse table
    ``winv`` becomes the live slot counts."""
    kept = {k: v for k, v in fields.items()
            if k not in _MOSAIC_FIELDS + ("winv",)}
    kept["n_live"] = live_counts(np.asarray(fields["lids"]),
                                 np.asarray(fields["winv"]))
    return _stencil_arrays(NHPiecesArrays, device, kept)
