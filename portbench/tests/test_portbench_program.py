"""The reduction of the port's ``tetsim.*`` spans in a Chrome trace
(``lib/program.py``) and the readers of the metrics built on it."""
from __future__ import annotations

import dataclasses
import glob
import os
import types

import pytest

from portbench.lib import cells, program, trace

from test_portbench_trace import EVENTS as OLD_EVENTS

HOST = {"pid": 1, "tid": 1}
OTHER = {"pid": 1, "tid": 2}
CARD = {"pid": 0, "tid": 7}


def _ev(cat, name, ts, dur, corr=None, where=HOST):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, **where}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _range(name, ts, dur, where=HOST):
    return _ev("user_annotation", name, ts, dur, where=where)


# One viewer frame (times in us): the harness's portbench.* spans, the
# port's nested tetsim.* spans inside them, a span on another thread and
# one that runs past the window's end.
EVENTS = [
    _range("portbench.window", 0.0, 1000.0),
    _range("portbench.grab", 0.0, 20.0),
    _range("tetsim.grab.move", 5.0, 10.0),
    _range("portbench.step_export", 20.0, 380.0),
    _range("tetsim.body.step_export", 25.0, 370.0),
    _range("tetsim.kernel.nh_stencil", 30.0, 50.0),
    _range("tetsim.export", 100.0, 290.0),
    _range("tetsim.export.positions", 100.0, 20.0),
    _range("tetsim.export.skin", 130.0, 70.0),
    _range("tetsim.export.normals", 210.0, 160.0),
    _range("portbench.copy", 400.0, 20.0),
    _range("portbench.wait", 420.0, 560.0),
    _range("tetsim.grab.end", 985.0, 115.0),
    _range("tetsim.export", 0.0, 1000.0, where=OTHER),
    _ev("cuda_runtime", "cudaLaunchCooperativeKernel", 70.0, 5.0, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 110.0, 3.0, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 150.0, 3.0, corr=3),
    _ev("cuda_runtime", "cudaLaunchKernel", 300.0, 3.0, corr=4),
    _ev("cuda_runtime", "cudaLaunchKernel", 380.0, 3.0, corr=5),
    _ev("cuda_runtime", "cudaMemcpyAsync", 405.0, 3.0, corr=6),
    _ev("cuda_runtime", "cudaLaunchKernel", 500.0, 3.0, corr=7, where=OTHER),
    _ev("cuda_driver", "cuLaunchKernel", 995.0, 10.0, corr=8),
    _ev("kernel", "nh_grid_frame_kernel", 90.0, 710.0, corr=1, where=CARD),
    _ev("kernel", "copy_kernel", 800.0, 10.0, corr=2, where=CARD),
    _ev("kernel", "gather_kernel", 810.0, 10.0, corr=3, where=CARD),
    _ev("kernel", "index_add_kernel", 820.0, 10.0, corr=4, where=CARD),
    _ev("kernel", "stack_kernel", 830.0, 5.0, corr=5, where=CARD),
    _ev("gpu_memcpy", "Memcpy DtoH", 840.0, 10.0, corr=6, where=CARD),
    _ev("kernel", "other_thread_kernel", 860.0, 10.0, corr=7, where=CARD),
]
# busy [90, 835], [840, 850], [860, 870]; innermost span over time: 5-15
# grab.move, 25-30 step_export, 30-80 kernel, 80-100 step_export, 100-120
# positions, 120-130 export, 130-200 skin, 200-210 export, 210-370
# normals, 370-390 export, 390-395 step_export, 985-1000 grab.end


def test_self_time_and_host_time():
    p = program.reduce(EVENTS, frames=2)
    s = p.spans
    assert s["tetsim.body.step_export"].host_s == pytest.approx(370e-6)
    assert s["tetsim.body.step_export"].self_s == pytest.approx(30e-6)
    assert s["tetsim.export"].host_s == pytest.approx(290e-6)
    assert s["tetsim.export"].self_s == pytest.approx(40e-6)
    assert s["tetsim.export.normals"].self_s == pytest.approx(160e-6)
    assert s[program.OUTSIDE].self_s == pytest.approx(
        1e-3 - 370e-6 - 10e-6 - 15e-6)
    assert p.host_s("tetsim.export") == pytest.approx(290e-6)
    assert p.host_s("tetsim.grab") == pytest.approx(25e-6)
    assert p.host_s("tetsim.kernel") == pytest.approx(50e-6)
    assert p.host_s("tetsim.body") == pytest.approx(370e-6)


def test_thread_filter_and_window_clip():
    """The other thread's range is dropped; the range past the window's
    end is cut at it."""
    p = program.reduce(EVENTS, frames=2)
    assert p.spans["tetsim.export"].count == 1
    assert p.spans["tetsim.grab.end"].host_s == pytest.approx(15e-6)
    assert all(0.0 <= a < b <= 1000.0 for _, a, b in p.ranges)


def test_device_ops_go_to_the_innermost_span_at_launch():
    p = program.reduce(EVENTS, frames=2)
    s = p.spans
    assert s["tetsim.kernel.nh_stencil"].ops == {
        "nh_grid_frame_kernel": [1, pytest.approx(710e-6)]}
    assert s["tetsim.body.step_export"].ops == {}
    assert set(s["tetsim.export.positions"].ops) == {"copy_kernel"}
    assert set(s["tetsim.export.skin"].ops) == {"gather_kernel"}
    assert set(s["tetsim.export.normals"].ops) == {"index_add_kernel"}
    assert set(s["tetsim.export"].ops) == {"stack_kernel"}
    # the copy's launch lies in no span; the other thread's launch counts
    # for no span of the window's thread
    assert set(s[program.OUTSIDE].ops) == {"Memcpy DtoH",
                                            "other_thread_kernel"}
    assert p.total("tetsim.export", "device_ops") == 4
    assert p.total("tetsim.export", "device_s") == pytest.approx(35e-6)


def test_idle_goes_to_the_innermost_span():
    p = program.reduce(EVENTS, frames=2)
    s = p.spans
    # idle: [0, 90], [835, 840], [850, 860], [870, 1000]
    assert s["tetsim.grab.move"].idle_s == pytest.approx(10e-6)
    assert s["tetsim.body.step_export"].idle_s == pytest.approx(15e-6)
    assert s["tetsim.kernel.nh_stencil"].idle_s == pytest.approx(50e-6)
    assert s["tetsim.grab.end"].idle_s == pytest.approx(15e-6)
    assert s[program.OUTSIDE].idle_s == pytest.approx(145e-6)
    assert p.total("tetsim.export", "idle_s") == 0.0
    assert sum(x.idle_s for x in s.values()) == pytest.approx(235e-6)


def test_runtime_calls_inside_a_family():
    """The runtime's and driver's calls of the window's thread, clipped to
    the window, split a family's host time; the other thread's call counts
    for none."""
    p = program.reduce(EVENTS, frames=2)
    assert p.runtime_s("tetsim.kernel") == pytest.approx(5e-6)
    assert p.runtime_s("tetsim.export") == pytest.approx(12e-6)
    assert p.runtime_s("tetsim.body") == pytest.approx(17e-6)
    assert p.runtime_s("tetsim.grab") == pytest.approx(5e-6)
    assert sum(b - a for a, b in p.calls) == pytest.approx(25.0)


def test_a_program_without_spans_reads_nothing():
    p = program.reduce(OLD_EVENTS, frames=2)
    assert set(p.spans) == {program.OUTSIDE}
    assert p.per_frame("tetsim.kernel", 0.0) is None
    with pytest.raises(RuntimeError):
        program.reduce(EVENTS[1:], frames=1)


@pytest.mark.parametrize("events", [OLD_EVENTS, EVENTS],
                         ids=["old_fixture", "spans_fixture"])
def test_trace_reduce_keeps_its_numbers(events):
    """Importing program.py leaves the events on what ``trace.reduce``
    returns and changes none of its fields; ``of`` reduces them once."""
    assert trace.reduce.keeps_events
    base = trace.reduce.__wrapped__(events, frames=2)
    kept = trace.reduce(events, frames=2)
    fields = [f.name for f in dataclasses.fields(trace.Trace)]
    assert ({f: getattr(kept, f) for f in fields}
            == {f: getattr(base, f) for f in fields})
    assert kept.breakdown() == base.breakdown()
    assert kept.events is events and not hasattr(base, "events")
    run = types.SimpleNamespace(trace=kept)
    p = program.of(run)
    assert isinstance(p, program.Program) and program.of(run) is p
    assert kept.events is None
    assert program.of(types.SimpleNamespace(trace=base)) is None


def _readers() -> dict:
    folder = os.path.join(cells.BENCH_DIR, "metrics")
    return {os.path.basename(p)[:-3]: cells.load_module(p, "metric")
            for p in glob.glob(os.path.join(folder, "*.py"))}


EXPECTED = {  # per frame of EVENTS' two
    "launch_us_per_frame.viewer": 25.0,
    "launch_us_per_frame.batch": 22.5,  # the launch call's 5 us left out
    "launch_us_per_frame.scale": 22.5,
    "grab_us_per_frame.viewer": 12.5,
    "launch_idle_us_per_frame.viewer": 25.0,
    "export_enqueue_us_per_frame.viewer": 145.0,
    "export_ops_per_frame.viewer": 2.0,
    "export_idle_us_per_frame.viewer": 0.0,
}


def test_readers():
    """Each reader on the spans, on a trace of a program without spans (a
    number-free reading, no error) and on an untraced run."""
    readers = _readers()
    for events, want in ((EVENTS, EXPECTED), (OLD_EVENTS, None)):
        run = types.SimpleNamespace(trace=trace.reduce(events, frames=2))
        for name in EXPECTED:
            got = readers[name].read(run)
            assert got == (None if want is None
                           else pytest.approx(want[name])), name
    untraced = types.SimpleNamespace(trace=None)
    assert all(readers[n].read(untraced) is None for n in EXPECTED)
