"""The port's own spans in a traced run: the ``tetsim.*`` ranges that
``tetsim_torch/spans.py`` opens while a profiler records, reduced per name.

Only ranges on the host thread that holds ``portbench.window`` count, each
clipped to that window.  The ranges of one thread nest; at each instant
the innermost open one is the one at work, so:

- a span's host seconds are the time inside it (a name that nests in
  itself counted once), its self seconds the time it is innermost;
- a device op (a kernel, copy or memset, clipped to the window as
  ``trace.reduce`` clips it) goes to the span innermost at its launch
  call, matched by correlation id;
- an idle gap of the card goes to the spans innermost while it lasts;
- the CUDA runtime's and driver's calls on that thread (a launch among
  them) are kept as time, so that a family's host time can be split into
  the port's own path and the time inside those calls: where frames are
  dispatched ahead, a launch waits there for room in the launch queue.

What lies in no ``tetsim.*`` span is kept under ``OUTSIDE``.  A family is
a name and the names under it (``tetsim.kernel`` holds every
``tetsim.kernel.<module>``).  Where the port opens no span, as a program
without them does, ``Program.spans`` holds ``OUTSIDE`` alone and every
family reads nothing.

``trace.traced`` drops a trace's events once ``trace.reduce`` has read
them.  So importing this module (a reader of a span metric does) wraps
``trace.reduce`` to leave the events on the ``Trace`` it returns, and
nothing more: the ``Trace``'s own numbers are as they were, and ``of``
reduces the spans on a reader's first call.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import functools

from portbench.lib import trace

PREFIX = "tetsim."
SPAN_CAT = "user_annotation"  # record_function's ranges
OUTSIDE = "outside"  # in the window, in no tetsim.* span


@dataclasses.dataclass
class Span:
    count: int = 0
    host_s: float = 0.0  # time inside the span, a nested repeat once
    self_s: float = 0.0  # time it was the innermost span
    idle_s: float = 0.0  # the card idle while it was innermost
    # device op name -> [count, seconds] of the ops launched while it was
    # innermost
    ops: dict = dataclasses.field(default_factory=dict)

    @property
    def device_s(self) -> float:
        return sum(s for _, s in self.ops.values())

    @property
    def device_ops(self) -> int:
        return sum(n for n, _ in self.ops.values())


@dataclasses.dataclass
class Program:
    frames: int
    spans: dict  # span name (or OUTSIDE) -> Span
    ranges: list  # (name, start, end) in microseconds, clipped, by start
    calls: list  # the runtime's and driver's calls: disjoint (start, end)

    def names(self, family: str) -> list:
        return [n for n in self.spans
                if n == family or n.startswith(family + ".")]

    def found(self, family: str) -> bool:
        return bool(self.names(family))

    def host_s(self, family: str) -> float:
        """Seconds inside any span of the family (nested ones once)."""
        return 1e-6 * _covered(self._of(family))

    def runtime_s(self, family: str) -> float:
        """Seconds of ``host_s(family)`` spent inside the CUDA runtime's and
        driver's calls."""
        return 1e-6 * _overlap(trace._union(self._of(family)), self.calls)

    def _of(self, family: str) -> list:
        return [(a, b) for n, a, b in self.ranges
                if n == family or n.startswith(family + ".")]

    def total(self, family: str, field: str) -> float:
        """The sum of a ``Span`` field over the family's names."""
        return sum(getattr(self.spans[n], field) for n in self.names(family))

    def per_frame(self, family: str, value: float):
        """``value`` over the traced frames; None where the family has no
        span or no frame ran."""
        if not self.frames or not self.found(family):
            return None
        return value / self.frames


def _covered(intervals) -> float:
    return sum(b - a for a, b in trace._union(intervals))


def _overlap(xs: list, ys: list) -> float:
    """Time that two lists of disjoint intervals, each by start, share."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        out += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _segments(ranges, w0: float, w1: float) -> list:
    """[w0, w1] cut into (start, end, innermost span name or OUTSIDE), in
    order, from nested ranges sorted by start.  A range that the rounding
    of the trace's times lets run past its parent's end is cut there."""
    out, stack = [], []
    t = w0

    def emit(upto):
        nonlocal t
        if upto > t:
            out.append((t, upto, stack[-1][0] if stack else OUTSIDE))
            t = upto

    for name, a, b in ranges:
        while stack and stack[-1][1] <= a:
            emit(stack[-1][1])
            stack.pop()
        emit(a)
        if stack:
            b = min(b, stack[-1][1])
        stack.append((name, b))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(w1)
    return out


def reduce(events: list, frames: int) -> Program:
    """A Chrome trace's events (times in microseconds) -> ``Program``."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == trace.PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace holds no portbench.window range")
    w = win[0]
    thread = (w.get("pid"), w.get("tid"))
    w0 = float(w["ts"])
    w1 = w0 + float(w["dur"])
    ranges = []
    for e in events:
        name = str(e.get("name", ""))
        if (not name.startswith(PREFIX) or e.get("cat") != SPAN_CAT
                or (e.get("pid"), e.get("tid")) != thread):
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ranges.append((name, a, b))
    ranges.sort(key=lambda r: (r[1], -r[2]))
    spans = collections.defaultdict(Span)
    for name, _, _ in ranges:
        spans[name].count += 1
    for name in spans:
        spans[name].host_s = 1e-6 * _covered(
            [(a, b) for n, a, b in ranges if n == name])
    segs = _segments(ranges, w0, w1)
    starts = [a for a, _, _ in segs]

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else OUTSIDE

    for a, b, name in segs:
        spans[name].self_s += 1e-6 * (b - a)
    runtime = [e for e in events if e.get("cat") in trace.LAUNCH_CATS
               and (e.get("pid"), e.get("tid")) == thread]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in runtime
              if "correlation" in e.get("args", {})}
    calls = []
    for e in runtime:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b > a:
            calls.append((a, b))
    calls = trace._union(calls)
    busy = []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        t = launch.get(e.get("args", {}).get("correlation"))
        op = spans[OUTSIDE if t is None else at(t)].ops.setdefault(
            str(e.get("name", "")), [0, 0.0])
        op[0] += 1
        op[1] += 1e-6 * (b - a)
    edges = [w0] + [x for ab in trace._union(busy) for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, name = segs[i]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                spans[name].idle_s += 1e-6 * part
            i += 1
    return Program(frames=int(frames), spans=dict(spans), ranges=ranges,
                   calls=calls)


def of(run):
    """The run's ``Program``, reduced from its trace's events on the first
    call; None where the run was not traced."""
    t = run.trace
    if getattr(t, "program", None) is None:
        events = getattr(t, "events", None)
        if events is None:
            return None
        t.program, t.events = reduce(events, t.frames), None
    return t.program


def _keep_events() -> None:
    if getattr(trace.reduce, "keeps_events", False):
        return

    @functools.wraps(trace.reduce)
    def reduce_keeping_events(events: list, frames: int) -> trace.Trace:
        t = reduce_keeping_events.__wrapped__(events, frames)
        t.events = events
        return t

    reduce_keeping_events.keeps_events = True
    trace.reduce = reduce_keeping_events


_keep_events()
