"""What decides ``correct``: the port's outputs against the plain reference
of the cell's configuration (``reference/<config>.py``), each number
against its limit in ``limits/<cell>.json`` (``Cell.limits``).

The numbers, each a largest absolute gap over every body and particle:

- ``start_pos`` / ``start_vel``: the state the port set up from the seed
  against the one the reference makes from the same seed and inputs.
- ``first_pos`` / ``first_vel``: the port's first calls (the set-up's
  own, through the cell's entry, as many frames to a call as the window
  asks for) against the reference run from its own start.
- ``frame_pos`` / ``frame_vel``: seeded calls of the window and its last
  call, the reference run as many frames as the call ran from the port's
  state before it.
  A frame inside a drag holds the particle that the reference finds
  nearest to the grab's point in the positions the port searched when the
  grab started, at the drag's target.  The trajectory is chaotic over
  thousands of frames (contact, Gauss-Seidel), so the window is followed
  frame by frame from the port's own state; the two numbers above check
  the start.
- ``grab_pos``: in those of them inside a drag, the particle that the
  reference finds nearest against the drag's target, which both hold it
  at: exact.
- ``export_verts`` / ``export_normals``: those frames' render exports, as
  the host received them, against the reference's skinning and normals of
  the reference's state after the frame.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import _xpbd


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in float64; inf where either is not finite."""
    d = (a.detach().to(torch.float64) - b.detach().to(a.device, torch.float64))
    d = d.abs().max().item() if d.numel() else 0.0
    return d if math.isfinite(d) else math.inf


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all().item())


def advance(ref, pos, vel, frames: int, grab=None):
    """``frames`` frames of ``ref`` from (pos, vel)."""
    for _ in range(frames):
        pos, vel = ref.frame(pos, vel, grab)
    return pos, vel


def judge(ref, inputs: dict, start: dict, window) -> dict:
    """The numbers compared, by name (see the module's docstring).
    ``start`` holds the port's initial (pos, vel) and, after each of its
    first calls, (frames, (pos, vel)); ``window`` the generator's record."""
    out = {}
    rp, rv = ref.initial(inputs)
    p0, v0 = start["initial"]
    out["start_pos"], out["start_vel"] = gap(p0, rp), gap(v0, rv)
    fp = fv = 0.0
    for n, (pp, pv) in start["after"]:
        rp, rv = advance(ref, rp, rv, n)
        fp, fv = max(fp, gap(pp, rp)), max(fv, gap(pv, rv))
    out["first_pos"], out["first_vel"] = fp, fv
    grabbed = {g.frame: g for g in window.grabs}
    fp = fv = ev = en = gp = 0.0
    exports = grabs = False
    for s in window.samples:
        grab = None
        if s.grab is not None:
            g = grabbed[s.grab[0]]
            grab = (int(np.argmin(_xpbd.distances(g.positions, g.point))),
                    s.grab[1])
        rp, rv = advance(ref, s.before[0], s.before[1], s.frames, grab)
        if grab is not None:
            grabs = True
            gp = max(gp, gap(s.after[0][:, grab[0]], torch.as_tensor(
                np.asarray(grab[1], np.float32))))
        fp = max(fp, gap(s.after[0], rp))
        fv = max(fv, gap(s.after[1], rv))
        if s.export is not None:
            exports = True
            want = ref.export(rp[0])
            got = torch.as_tensor(s.export)
            ev = max(ev, gap(got[0], want[0]))
            en = max(en, gap(got[1], want[1]))
    if window.samples:
        out["frame_pos"], out["frame_vel"] = fp, fv
    if grabs:
        out["grab_pos"] = gp
    if exports:
        out["export_verts"], out["export_normals"] = ev, en
    return out


def failed_frames(window) -> int:
    """Frames that raised or left a state that is not finite: the frame
    that raised, or every frame after the last sample whose state after it
    was finite."""
    if window.error is not None:
        return 1
    if window.finite:
        return 0
    ok = [s.frame + s.frames for s in window.samples
          if _finite(s.after[0]) and _finite(s.after[1])
          and (s.export is None or np.isfinite(s.export).all())]
    return window.frames - max(ok, default=0)


def correct(checks: dict, bounds: dict, window) -> bool:
    """Every number of the limits file present and within its limit, no
    frame failed."""
    return (window.error is None and failed_frames(window) == 0
            and set(checks) == set(bounds)
            and all(checks[k] <= bounds[k] for k in bounds))
