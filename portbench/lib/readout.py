"""Small sums the metric readers share (``metrics/<metric>.py``)."""
from __future__ import annotations

from portbench.lib import work


def device_s_per_frame(run, part: str):
    """Device seconds a traced frame of the ops whose names hold ``part``;
    None without a trace or where none ran."""
    t = run.trace
    if t is None or not t.frames:
        return None
    s = t.op_seconds(part)
    return s / t.frames if s > 0 else None


def idle_percent(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def k1_bound_s(run) -> float:
    """K1's least time a frame of the run's batch (one grab slot a body)."""
    c = run.cell.config
    return work.bound_s(
        work.k1_frame_flops(c["tets"], c["particles"], run.substeps,
                            run.bodies),
        work.k1_frame_bytes(c["tets"], c["particles"], run.substeps,
                            run.bodies, 1))


def k3_bound_s(run) -> float:
    """K3's least time a frame of the run's box (one grab slot)."""
    dims = run.cell.config["dims"]
    return work.bound_s(work.k3_frame_flops(dims, run.substeps, run.bodies),
                        work.k3_frame_bytes(dims, run.substeps, run.bodies, 1))

