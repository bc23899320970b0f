"""The traced run's reading of the card: a ``torch.profiler`` session over
a short tail of the cell's own traffic, exported as a Chrome trace and
reduced to what the per-layer readers need.

Arithmetic as ``profile_frame.py`` and ``chip_smoke.py`` phase 28 do it:
device activity is the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; a device event belongs to the host span whose time
holds its launch call (matched by the launch's correlation id).  Added
here: the busy time is the union of device activity inside the traced
window (the ``portbench.window`` range), and each idle gap of the card is
split over the ``portbench.*`` spans of the host that cover it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "portbench."
NAME_CHARS = 120  # a device op's name in the breakdown, cut to this length


@dataclasses.dataclass
class Trace:
    window_s: float  # length of the traced window
    busy_s: float  # union of device activity inside it
    frames: int  # frames the traced window ran
    ops: dict  # device op name -> [count, seconds]
    by_span: dict  # host span name -> {device op name: seconds} it launched
    idle_by_span: dict  # host span name -> seconds the card idled under it

    def op_seconds(self, part: str) -> float:
        """Seconds of the device ops whose names hold ``part``."""
        return sum(s for name, (_, s) in self.ops.items() if part in name)

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def traced(run):
    """Runs ``run()`` (which returns the frames it ran) inside a profiler
    session and a ``portbench.window`` range that ends in a sync; returns
    the ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(PREFIX + "window"):
                frames = run()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events, frames)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """The host's ``portbench.*`` spans inside the window, which never
    overlap (the loops open them one after another), by start time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [a for _, a, _ in self.spans]

    def at(self, t: float):
        """Name of the span holding time t, or "other"."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][2]:
            return self.spans[i][0]
        return "other"

    def overlap(self, a: float, b: float) -> dict:
        """Microseconds of [a, b] under each span name ("other": none)."""
        out = collections.defaultdict(float)
        covered = 0.0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.spans) and self.spans[i][1] < b:
            name, s0, s1 = self.spans[i]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] += part
                covered += part
            i += 1
        if b - a > covered:
            out["other"] += b - a - covered
        return out


def reduce(events: list, frames: int) -> Trace:
    """A Chrome trace's events (times in microseconds) -> ``Trace``."""
    spans = [(e["name"][len(PREFIX):], float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("the trace holds no portbench.window range")
    _, w0, w1 = win[0]
    inner = _Spans([s for s in spans if s[0] != "window"])
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    ops = collections.defaultdict(lambda: [0, 0.0])
    by_span = collections.defaultdict(lambda: collections.defaultdict(float))
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        name = str(e.get("name", ""))
        ops[name][0] += 1
        ops[name][1] += (b - a) * 1e-6
        t = launch.get(e.get("args", {}).get("correlation"), a)
        by_span[inner.at(t)][name] += (b - a) * 1e-6
    merged = _union(busy)
    idle = collections.defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            for name, us in inner.overlap(a, b).items():
                idle[name] += us * 1e-6
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in merged) * 1e-6,
        frames=int(frames), ops={k: list(v) for k, v in ops.items()},
        by_span={k: dict(v) for k, v in by_span.items()},
        idle_by_span=dict(idle),
    )
