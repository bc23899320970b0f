"""Diagnostics (counterpart of ``tetsim_tpu/diag.py``): volume error,
kinetic energy, speed and height of a body, as device tensors;
``summarize`` brings them to the host in one transfer; ``trace`` writes
a timeline of what runs inside it.  Grid bodies
(``GridArrays``, ``NHGridArrays``) carry no tet table: their volume error
is read from the stencil's corner offsets.  Pieces bodies (``PiecesArrays``,
``NHPiecesArrays``) carry no global tet table either, and report no volume
error."""
from __future__ import annotations

import json
import math
import os
import warnings

import torch

from .kernels.nh_pieces import NHPiecesArrays
from .kernels.polar_pieces import PiecesArrays
from .mesh import TetArrays
from .solvers.polar_grid import SLAB_OFFSETS
from .state import SimState
from .utils import mat3


def volume_error(state: SimState, arr: TetArrays):
    """Mean (det F - 1) over tets — the reference's volError diagnostic."""
    p = state.pos[arr.tets.long()]  # [M,4,3]
    d = torch.stack(
        [p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :],
         p[..., 3, :] - p[..., 0, :]],
        dim=-1,
    )
    f = mat3.matmul(d, arr.inv_rest_pose)
    return (mat3.det(f) - 1.0).mean()


def grid_volume_error(state: SimState, garr):
    """Mean (det F - 1) over the tets of a grid body (``GridArrays`` or
    ``NHGridArrays``): each Kuhn type's corners are shifted views of the
    vertex grid, and a tet's det F is its volume over the rest volume."""
    nx, ny, nz = garr.dims
    pos = state.pos.reshape(nx + 1, ny + 1, nz + 1, 3)
    total = pos.new_zeros(())
    for t in range(6):
        p = [pos[dx:dx + nx, dy:dy + ny, dz:dz + nz].reshape(-1, 3)
             for (dx, dy, dz) in (SLAB_OFFSETS[s] for s in garr.corner_slab[t])]
        d = torch.stack([p[1] - p[0], p[2] - p[0], p[3] - p[0]], dim=-1)
        vol = mat3.det(d) / 6.0
        total = total + (vol / garr.rest_volume - 1.0).sum()
    return total / (6 * nx * ny * nz)


def kinetic_energy(state: SimState, arr):
    """0.5 * sum m |v|^2 (pinned particles with inv_mass 0 excluded)."""
    im = arr.inv_mass.reshape(-1)
    m = torch.where(im > 0, 1.0 / im.clamp(min=1e-30), 0.0)
    return 0.5 * (m * (state.vel ** 2).sum(dim=-1)).sum()


def max_speed(state: SimState):
    return torch.linalg.vector_norm(state.vel, dim=-1).max()


def min_height(state: SimState):
    return state.pos[..., 1].min()


class trace:
    """Context manager around ``torch.profiler`` for a timeline of the CPU
    work and, where CUDA is available, the card's kernels and copies:

        with diag.trace("traces"):
            world.step(30)

    On exit it writes a Chrome trace, ``trace_<pid>_<n>.json``, into
    ``log_dir`` (made if missing) and keeps its path in ``path``; open it
    in Perfetto or ``chrome://tracing``.  The port's ``tetsim.*`` spans
    (``spans.py``) are on while it records: ``tetsim.world.step``, a
    viewer frame's ``tetsim.body.step_export``, the ``tetsim.grab.*``
    calls, each kernel entry's ``tetsim.kernel.<module>``, the export's
    ``tetsim.export`` (``.positions``, ``.skin``, ``.normals``) and a
    native library's ``tetsim.build``.  Where CUDA was traced and the
    trace holds no kernel, copy or memset event, it warns
    (``device_events``)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None
        self._cuda = False

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        n = len([f for f in os.listdir(self.log_dir) if f.startswith("trace_")])
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{n}.json")
        self._prof.export_chrome_trace(self.path)
        if self._cuda and exc[0] is None:
            device_events(self.path)
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(path: str) -> int:
    """The kernel, copy and memset events of the Chrome trace at ``path``;
    warns where there are none (a CUDA session that recorded nothing of
    the card)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    n = sum(1 for e in events if e.get("cat") in DEVICE_CATS)
    if n == 0:
        warnings.warn(f"{path}: the trace holds no kernel, copy or memset "
                      "event of the card", RuntimeWarning, stacklevel=2)
    return n


def summarize(state: SimState, arr, frame_diag=None) -> dict:
    """Diagnostics of one body as Python numbers.  ``frame_diag`` is the
    last frame's vol_errs [num_substeps]; its last entry becomes
    ``solver_vol_error`` when finite (engines that compute no volume error
    report NaN).  Pieces bodies have no ``volume_error`` key."""
    names = ["kinetic_energy", "max_speed", "min_height", "nan"]
    vals = [kinetic_energy(state, arr), max_speed(state), min_height(state),
            torch.isnan(state.pos).any().to(torch.float32)]
    if isinstance(arr, TetArrays):
        names.append("volume_error")
        vals.append(volume_error(state, arr))
    elif not isinstance(arr, (PiecesArrays, NHPiecesArrays)):
        names.append("volume_error")
        vals.append(grid_volume_error(state, arr))
    if frame_diag is not None and frame_diag.numel():
        names.append("solver_vol_error")
        vals.append(frame_diag.reshape(-1)[-1])
    out = dict(zip(names, torch.stack(vals).tolist()))  # one transfer
    out["nan"] = bool(out["nan"])
    if not math.isfinite(out.get("solver_vol_error", 0.0)):
        del out["solver_vol_error"]
    return out
