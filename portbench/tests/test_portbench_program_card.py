"""Runs on the card: a short traced viewer window of a tiny packed box,
its device ops put under the port's spans (``lib/program.py``).  Skips
where there is no card."""
from __future__ import annotations

import types

import numpy as np
import pytest

from portbench.lib import cells, loop, program, trace


@pytest.mark.card
def test_viewer_ops_under_the_port_spans(card, bench_root):
    cell = cells.resolve("box2_nh.tinyview", bench_root)
    cfg, traffic = cell.config, cell.traffic
    inputs = cell.builder.inputs(cfg, traffic, 7, card)
    drive = loop.driver(cell.builder.build(cfg, traffic, inputs, card),
                        traffic, np.random.default_rng(7))
    drive.warm_up(int(traffic["warmup_frames"]), 0)
    t = trace.traced(lambda: drive.window(0.5, [], traced=True).frames)
    p = program.of(types.SimpleNamespace(trace=t))
    solver = cfg["solver_kernel"]
    where = {name: span for name, span in p.spans.items()
             for op in span.ops if solver in op}
    assert set(where) == {"tetsim.kernel.nh_stencil"}, where
    export = [op for n in p.names("tetsim.export") for op in p.spans[n].ops]
    assert export and not any(solver in op for op in export)
    assert p.total("tetsim.export.normals", "device_ops") > 0
    assert p.total("tetsim.export.skin", "device_ops") > 0
    assert p.host_s("tetsim.grab") > 0
