"""The port's ``tetsim.*`` spans (``tetsim_torch/spans.py``): off, one
shared null context; under a CPU ``torch.profiler`` session, a viewer
frame's and a ``World.step``'s ranges nested as the module lists them; a
compiler run's ``tetsim.build``; ``diag.trace``'s warning on a CUDA trace
with nothing of the card in it."""
import json
import os
import sys
import warnings

import pytest
import torch

import tetsim_torch as tt
from tetsim_torch import _compile, diag, spans

torch.set_num_threads(1)


def _ranges(prof, tmp_path) -> list:
    """(name, start, end) of the tetsim.* ranges of a finished session."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if str(e.get("name", "")).startswith(spans.PREFIX)
            and e.get("cat") == "user_annotation"]


def _profiled(fn, tmp_path) -> list:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _ranges(prof, tmp_path)


def _inside(child, parents) -> bool:
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


def _named(ranges, name) -> list:
    return [r for r in ranges if r[0] == name]


def test_span_off_is_one_shared_null_context(monkeypatch):
    """With no session recording, ``span`` hands out the same null context
    every time and makes no range."""
    assert not torch.autograd._profiler_enabled()

    def no_range(name):
        raise AssertionError(f"a range for {name} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    first = spans.span(spans.EXPORT)
    assert first is spans.span(spans.kernel("tetsim_torch.kernels.gs_fused"))
    with first:
        with spans.span(spans.STEP_EXPORT):
            pass
    assert spans.kernel("tetsim_torch.kernels.nh_stencil") == \
        "tetsim.kernel.nh_stencil"


def _box(device="cpu"):
    """A 2x2x2 packed Neo-Hookean box with its surface export, as the
    viewer's --grid path sets it up."""
    world = tt.World(tt.PhysicsParams(num_substeps=1), device=device)
    body = world.add_grid_body((2, 2, 2), cell=0.05, origin=(0.0, 0.5, 0.0),
                               engine="neohookean_grid_pallas", packed=True,
                               with_surface=True)
    s = body._surface
    body.enable_render_export(s.skin_ids, s.skin_w, s.tris)
    return world, body


def _dragon():
    world = tt.World(tt.PhysicsParams(num_substeps=1), device="cpu")
    body = world.add_body(tt.load_dragon(), engine="neohookean",
                          coloring="greedy")
    body.enable_render_export()
    return world, body


@pytest.mark.parametrize("scene,kernel", [(_box, "nh_stencil"),
                                          (_dragon, "gs_fused")])
def test_viewer_frame_spans_nest(scene, kernel, tmp_path):
    """A grab, a dragged frame and a release of the viewer's loop: each
    grab call is its span; ``step_many_export`` holds the kernel entry
    and the export, the export its positions, skinning and normals."""
    world, body = scene()

    def frames():
        body.start_grab([0.0, 0.6, 0.0])
        body.step_many_export(world.params, 1)
        body.move_grabbed([0.0, 0.7, 0.0])
        body.step_many_export(world.params, 1)
        body.end_grab()

    ranges = _profiled(frames, tmp_path)
    for name in (spans.GRAB_START, spans.GRAB_MOVE, spans.GRAB_END):
        assert len(_named(ranges, name)) == 1, name
    frame = _named(ranges, spans.STEP_EXPORT)
    assert len(frame) == 2
    for name in (spans.kernel(kernel), spans.EXPORT):
        found = _named(ranges, name)
        assert len(found) == 2 and all(_inside(r, frame) for r in found)
    export = _named(ranges, spans.EXPORT)
    for name in (spans.EXPORT_POSITIONS, spans.EXPORT_SKIN,
                 spans.EXPORT_NORMALS):
        found = _named(ranges, name)
        assert len(found) == 2 and all(_inside(r, export) for r in found)
    grabs = [r for r in ranges if r[0].startswith(spans.PREFIX + "grab")]
    assert not any(_inside(r, frame) for r in grabs)


def test_world_step_holds_the_kernel_entries(tmp_path):
    """``World.step`` of a fused batch: one ``tetsim.world.step`` a call,
    one kernel entry a frame inside it."""
    world = tt.World(tt.PhysicsParams(num_substeps=1), device="cpu")
    world.add_body_batch(tt.load_dragon(), 2, engine="neohookean",
                         backend="fused", jitter=0.5)
    ranges = _profiled(lambda: world.step(2), tmp_path)
    call = _named(ranges, spans.WORLD_STEP)
    found = _named(ranges, spans.kernel("gs_fused"))
    assert len(call) == 1 and len(found) == 2
    assert all(_inside(r, call) for r in found)


def test_build_span_only_when_the_compiler_runs(tmp_path, monkeypatch):
    """``compiled_library`` opens ``tetsim.build`` around a compiler run,
    and not on a cache hit."""
    monkeypatch.setattr(_compile, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "lib.c"
    src.write_text("int f(void) { return 1; }\n")

    def command(source, out):
        return [sys.executable, "-c",
                f"open({out!r}, 'w').write(open({source!r}).read())"]

    def build():
        return _compile.compiled_library(str(src), "lib", command)

    first = _profiled(build, tmp_path)
    assert len(_named(first, spans.BUILD)) == 1
    assert os.path.exists(build())
    assert not _named(_profiled(build, tmp_path), spans.BUILD)


def _trace_file(path, events) -> str:
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_trace_warns_without_device_events(tmp_path):
    """``diag.device_events`` (what ``diag.trace`` runs after a CUDA
    session) warns on a trace that holds no kernel, copy or memset event,
    and counts them where there are some."""
    host = [{"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 1.0},
            {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.5,
             "dur": 0.1, "args": {"correlation": 1}}]
    empty = _trace_file(tmp_path / "empty.json", host)
    with pytest.warns(RuntimeWarning, match="no kernel, copy or memset"):
        assert diag.device_events(empty) == 0
    full = _trace_file(tmp_path / "full.json", host + [
        {"cat": "kernel", "name": "k", "ts": 1.0, "dur": 2.0,
         "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 3.0, "dur": 1.0}])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert diag.device_events(full) == 2
