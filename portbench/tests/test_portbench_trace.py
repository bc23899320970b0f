"""The reduction of a Chrome trace to busy and idle time, per-op device
time and what the host did while the card idled."""
from __future__ import annotations

import pytest

from portbench.lib import trace


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("user_annotation", "portbench.window", 0.0, 1000.0),
    _ev("user_annotation", "portbench.step_export", 0.0, 100.0),
    _ev("user_annotation", "portbench.copy", 100.0, 20.0),
    _ev("user_annotation", "portbench.wait", 120.0, 700.0),
    _ev("gpu_user_annotation", "portbench.step_export", 0.0, 900.0),
    _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 50.0, 5.0, corr=2),
    _ev("cuda_runtime", "cudaMemcpyAsync", 105.0, 5.0, corr=3),
    _ev("kernel", "gs_frame_kernel", 20.0, 500.0, corr=1),
    _ev("kernel", "skin", 400.0, 200.0, corr=2),  # overlaps the first
    _ev("gpu_memcpy", "Memcpy DtoH", 700.0, 50.0, corr=3),
]


def test_reduce():
    t = trace.reduce(EVENTS, frames=2)
    assert t.window_s == pytest.approx(1e-3)
    # busy: [20, 600] and [700, 750]
    assert t.busy_s == pytest.approx(630e-6)
    assert t.ops["gs_frame_kernel"] == [1, pytest.approx(500e-6)]
    assert t.op_seconds("gs_frame") == pytest.approx(500e-6)
    assert t.by_span["step_export"] == {"gs_frame_kernel": pytest.approx(5e-4),
                                        "skin": pytest.approx(2e-4)}
    assert t.by_span["copy"] == {"Memcpy DtoH": pytest.approx(5e-5)}
    # idle: [0, 20] under step_export, [600, 700] under wait,
    # [750, 820] under wait and [820, 1000] under no span
    assert t.idle_by_span["step_export"] == pytest.approx(20e-6)
    assert t.idle_by_span["wait"] == pytest.approx(170e-6)
    assert t.idle_by_span["other"] == pytest.approx(180e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["gs_frame_kernel", pytest.approx(5e-4)]
    assert b["idle_gaps"][0] == ["other", pytest.approx(180e-6)]


def test_no_window_raises():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[1:], frames=1)
