"""One run of one cell: set-up, the measured window, on ``--trace 1`` a
traced tail, then the comparison with the reference and the metrics.

``run_cell`` takes the device from its caller.  ``run.py`` gives it the
card and refuses to run without one; the CPU tests give it the CPU, where
the port runs its plain twins, to drive everything but the card.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from portbench.lib import cells, control, loop, trace, verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "tetsim_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``tetsim_torch`` shares a prefix with ``tetsim_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``metrics/<metric>.py``: read(run))."""

    cell: cells.Cell
    seconds: float
    setup_s: float
    window: loop.Window
    trace: Optional[trace.Trace]
    bodies: int
    substeps: int


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             root: str, device, t_start: float, controls=(), samples=None,
             inspect=None):
    """Runs the cell once; returns (result dict for the JSON line, the
    numbers compared as {name: (value, limit)}).  For calibration only:
    ``controls`` (names of ``control.DTYPES``) adds ``result["control"]``,
    each control's numbers on this run's window; ``samples`` replaces the
    mix's count of sampled calls; ``inspect(ref, inputs, start, window)``
    adds what it returns as ``result["inspect"]``."""
    if seed < 0:
        raise ValueError("--seed is a whole number of at least 0")
    cell = cells.resolve(workload, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and torch.cuda.device_count() < cell.chips:
        raise RuntimeError(f"{workload} needs {cell.chips} cards, the host "
                           f"has {torch.cuda.device_count()}")
    cfg, traffic = cell.config, cell.traffic
    grab_rng, sample_rng = (np.random.default_rng(s) for s in
                            np.random.SeedSequence(seed).spawn(2))

    marks = [("imports_s", time.perf_counter())]
    torch.zeros(1, device=dev)  # the CUDA context
    marks.append(("context_s", time.perf_counter()))
    inputs = cell.builder.inputs(cfg, traffic, seed, dev)
    scene = cell.builder.build(cfg, traffic, inputs, dev)
    start = {"initial": scene.capture()}
    marks.append(("scene_s", time.perf_counter()))
    drive = loop.driver(scene, traffic, grab_rng)
    start["after"] = drive.warm_up(int(traffic["warmup_frames"]),
                                   int(traffic["start_calls"]))
    if cuda:
        torch.cuda.synchronize(dev)
    count = int(traffic["samples"] if samples is None else samples)
    at = loop.sample_times(sample_rng, count, seconds)
    marks.append(("warmup_s", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = {name: t - before for (name, t), before in
             zip(marks, [t_start] + [t for _, t in marks[:-1]])}
    window = drive.window(seconds, at)

    tr = None
    if traced and window.error is None and cuda:
        tr = trace.traced(lambda: drive.window(
            float(traffic["trace_seconds"]), [], traced=True).frames)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bodies, substeps = scene.bodies, scene.substeps
    del scene, drive  # the program's scene; the samples keep their tensors
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    try:
        ref = cell.reference.Reference(cfg, traffic, root, dev)
        checks = verdict.judge(ref, inputs, start, window)
    except Exception:  # a reference that cannot judge: not correct
        traceback.print_exc()
        checks, ref = {}, None
    reference_s = time.perf_counter() - t_ref
    looked = None if inspect is None or ref is None else inspect(
        ref, inputs, start, window)
    ctrl = {name: control.checks(cell, inputs, start, window, dev,
                                 control.DTYPES[name]) for name in controls}
    run = Run(cell, seconds, setup_s, window, tr, bodies, substeps)
    specs = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for spec in specs:
        value = cell.readers[spec["name"]].read(run)
        if value is not None and math.isfinite(value):
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    failed = verdict.failed_frames(window)
    ok = verdict.correct(checks, cell.limits, window)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok),
              "attempted": window.frames + (window.error is not None),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    compared = {k: (checks.get(k, math.inf), cell.limits[k])
                for k in cell.limits}
    compared.update({k: (v, None) for k, v in checks.items()
                     if k not in cell.limits})
    result["setup_parts"] = parts  # where set-up went (not compared)
    result["reference_s"] = reference_s  # the comparison's time (not compared)
    if window.error is not None:
        result["error"] = window.error
    if ctrl:
        result["control"] = ctrl
    if looked is not None:
        result["inspect"] = looked
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    return result, compared
