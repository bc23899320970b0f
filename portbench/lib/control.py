"""The control of the comparison: the reference itself, computed in a lower
precision than the configuration states (bfloat16 for float32), put in
the port's place and judged by the same numbers and limits.  A limit is
sound only where the control fails it.

The control starts from the same seed and inputs, runs the first calls'
frames from its own start, runs each sampled call's frames from the
port's state before it (rounded to the control's precision) with the grab the port had,
exports its own state after the frame, and picks each grab's particle by
its own distances.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import loop, verdict

DTYPES = {"bfloat16": torch.bfloat16}  # the control of float32


def checks(cell, inputs: dict, start: dict, window, device,
           dtype=torch.bfloat16) -> dict:
    """The numbers ``verdict.judge`` gives the control, in the place of the
    port's ``start`` and ``window``."""
    ref = cell.reference.Reference(cell.config, cell.traffic, cell.root,
                                   device)
    low = cell.reference.Reference(cell.config, cell.traffic, cell.root,
                                   device, dtype=dtype)
    p, v = low.initial(inputs)
    mine = {"initial": (p, v), "after": []}
    for n, _ in start["after"]:
        p, v = verdict.advance(low, p, v, n)
        mine["after"].append((n, (p, v)))
    chosen = {}
    for g in window.grabs:
        pos = g.positions.to(dtype)
        point = torch.as_tensor(np.asarray(g.point), device=pos.device)
        chosen[g.frame] = int(((pos - point.to(dtype)) ** 2).sum(-1).argmin())
    w = loop.Window(frames=window.frames, wall_s=window.wall_s,
                    grabs=window.grabs)
    for s in window.samples:
        grab = None if s.grab is None else (chosen[s.grab[0]], s.grab[1])
        after = verdict.advance(low, s.before[0], s.before[1], s.frames,
                                grab)
        export = None
        if s.export is not None:
            export = low.export(after[0][0]).float().cpu().numpy()
        w.samples.append(loop.Sample(s.frame, s.before, after, s.frames,
                                     s.grab, export))
    return verdict.judge(ref, inputs, mine, w)
