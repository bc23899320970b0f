"""The one traffic generator.  A mix (``traffic/<mix>.json``) is data;
its ``loop`` picks one of two ways to drive a scene, and its other keys
size them.

``"loop": "ahead"`` — frames enqueued with no host sync inside the window
(``frames_per_call`` frames to a ``World.step`` call), the window ended by
a data-dependent reduction that the host reads: the rate of a batch or of
one large body.  Every call, the checked ones too, asks for
``frames_per_call`` frames, so the comparison follows the timed call.

``"loop": "closed"`` — the viewer's loop, one client, unpaced: each frame
is one ``step_many_export(params, 1)``, its [2, S, 3] export copied into
a pinned host buffer, and the host waits on the copy's event before the
next frame starts; the client's drag point is worked out before the
frame's clock starts.  A seeded grab schedule runs beside it (``grab``): a grab at
a seeded vertex of the last exported surface, dragged along a vertical
circle of ``radius_m`` at ``hz`` through that point (``move_grabbed``
every frame) for ``drag_frames`` frames, then ``end_grab`` and
``free_frames`` free frames, again and again.

Both record what the comparison with the reference needs: the state before
and after seeded sample calls (device tensors, held, not copied, where
the port hands out its own) with the frames each call ran, the exports of
those frames, and each grab with the positions it searched.  Set-up's
first ``start_calls`` calls are captured the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import traceback
from typing import Optional

import numpy as np
import torch

UP = np.array([0.0, 1.0, 0.0], np.float32)


@dataclasses.dataclass
class Sample:
    frame: int  # the window's frame count before the call
    before: tuple  # (pos, vel) [B, N, 3] on the device
    after: tuple
    frames: int = 1  # frames the call ran between the two
    grab: Optional[tuple] = None  # (frame of its GrabStart, target f32 [3])
    export: Optional[np.ndarray] = None  # [2, S, 3] as the host received it


@dataclasses.dataclass
class GrabStart:
    frame: int
    point: np.ndarray  # f32 [3]
    particle: int  # what start_grab returned
    positions: torch.Tensor  # [N, 3]: the positions it searched


@dataclasses.dataclass
class Window:
    frames: int = 0
    wall_s: float = 0.0
    frame_s: list = dataclasses.field(default_factory=list)  # closed loop
    enqueue_s: list = dataclasses.field(default_factory=list)  # closed loop
    samples: list = dataclasses.field(default_factory=list)
    grabs: list = dataclasses.field(default_factory=list)
    finite: bool = True  # the token's (ahead) or the last export's verdict
    error: Optional[str] = None  # what the frame that raised said


def sample_times(rng: np.random.Generator, count: int, seconds: float) -> list:
    """``count`` seeded offsets into a window of ``seconds``, sorted."""
    return sorted(float(x) for x in rng.uniform(0.05, 0.95, count) * seconds)


def driver(scene, traffic: dict, rng: np.random.Generator):
    return {"ahead": Ahead, "closed": Closed}[traffic["loop"]](scene, traffic,
                                                                rng)


def _span(name: str, on: bool):
    return (torch.profiler.record_function(f"portbench.{name}") if on
            else contextlib.nullcontext())


class Ahead:
    """Frames dispatched ahead; the window ends in a host read."""

    def __init__(self, scene, traffic: dict, rng):
        self.scene = scene
        self.per_call = int(traffic["frames_per_call"])

    def warm_up(self, frames: int, start_calls: int) -> list:
        """``start_calls`` calls, the state after each captured with the
        frames it follows, then calls up to ``frames`` frames; ends in a
        host read."""
        after = []
        for _ in range(start_calls):
            self.scene.dispatch(self.per_call)
            after.append((self.per_call, self.scene.capture()))
        left = frames - start_calls * self.per_call
        while left > 0:
            self.scene.dispatch(self.per_call)
            left -= self.per_call
        self.scene.token().tolist()
        return after

    def _sampled(self, w: Window) -> None:
        before = self.scene.capture()
        self.scene.dispatch(self.per_call)
        w.samples.append(Sample(w.frames, before, self.scene.capture(),
                                self.per_call))
        w.frames += self.per_call

    def window(self, seconds: float, at: list, traced: bool = False) -> Window:
        w = Window()
        at = list(at)
        t0 = time.perf_counter()
        try:
            with _span("dispatch", traced):
                while True:
                    now = time.perf_counter() - t0
                    if now >= seconds:
                        break
                    if at and now >= at[0]:
                        at.pop(0)
                        self._sampled(w)
                    else:
                        self.scene.dispatch(self.per_call)
                        w.frames += self.per_call
                self._sampled(w)  # the window's last call
            with _span("sync", traced):
                total, ok = self.scene.token().tolist()
            w.finite = bool(ok) and math.isfinite(total)
        except Exception as e:  # a frame that raises is a failed frame
            w.error = "".join(traceback.format_exception_only(e)).strip()
        w.wall_s = time.perf_counter() - t0
        return w


class Closed:
    """The viewer's loop: a frame, its export to the host, a wait."""

    def __init__(self, scene, traffic: dict, rng):
        self.scene = scene
        g = traffic["grab"]
        self.drag, self.free = int(g["drag_frames"]), int(g["free_frames"])
        self.radius, self.hz = float(g["radius_m"]), float(g["hz"])
        self.fps = 1.0 / float(scene.params.time_step)
        self.rng = rng
        self.phase = self.drag  # the first frames are free
        self.last = None  # the last export, on the host
        self.center = self.across = None
        self.particle = -1
        self.started = -1  # window frame of the running grab's start
        self.cuda = torch.device(scene.body.device).type == "cuda"
        self.staging = self.event = None  # the export's pinned buffer

    def _target(self, k: int) -> np.ndarray:
        """The drag's point k frames after its start: a vertical circle
        whose lowest point is the grabbed vertex."""
        a = 2.0 * math.pi * self.hz * k / self.fps
        return (self.center + self.radius * (math.sin(a) * self.across
                                             - math.cos(a) * UP)
                ).astype(np.float32)

    def _new_grab(self) -> None:
        verts = self.last[0]
        point = verts[int(self.rng.integers(verts.shape[0]))]
        turn = float(self.rng.uniform(0.0, 2.0 * math.pi))
        self.across = np.array([math.cos(turn), 0.0, math.sin(turn)],
                               np.float32)
        self.center = point + self.radius * UP

    def _to_host(self, vn: torch.Tensor):
        """The export's copy into one pinned buffer, reused every frame as a
        viewer's staging buffer is (each frame waits on the copy, and the
        host reads the buffer only between a frame's wait and the next
        frame's copy), and an event recorded after it."""
        if not self.cuda:
            return vn.clone(), None
        if self.staging is None or self.staging.shape != vn.shape:
            self.staging = torch.empty(vn.shape, dtype=vn.dtype,
                                       pin_memory=True)
            self.event = torch.cuda.Event()
        self.staging.copy_(vn, non_blocking=True)
        self.event.record()
        return self.staging, self.event

    def frame(self, w: Optional[Window] = None, sample: bool = False,
              traced: bool = False) -> None:
        """One frame.  With a window: its times, and where ``sample`` its
        state before and after and its export."""
        k = self.phase % (self.drag + self.free)
        starting = k == 0
        if starting:
            self._new_grab()
        searched = (self.scene.grab_positions() if starting and w is not None
                    else None)
        before = self.scene.capture() if sample else None
        # the client's drag point, worked out before the frame's clock starts
        point = self._target(k) if k < self.drag else None
        t0 = time.perf_counter()
        with _span("grab", traced):
            if starting:
                self.particle = self.scene.start_grab(point)
            elif k < self.drag:
                self.scene.move_grabbed(point)
            elif k == self.drag:
                self.scene.end_grab()
        with _span("step_export", traced):
            vn = self.scene.step_export()
        t1 = time.perf_counter()
        with _span("copy", traced):
            host, event = self._to_host(vn)
        with _span("wait", traced):
            if event is not None:
                event.synchronize()
        t2 = time.perf_counter()
        self.phase += 1
        self.last = host.numpy()
        if w is None:
            return
        w.frame_s.append(t2 - t0)
        w.enqueue_s.append(t1 - t0)
        if starting:
            self.started = w.frames
            w.grabs.append(GrabStart(w.frames, point, self.particle,
                                     searched))
        if sample:
            grab = (self.started, point) if k < self.drag else None
            w.samples.append(Sample(w.frames, before, self.scene.capture(),
                                    grab=grab, export=self.last.copy()))
        w.frames += 1

    def warm_up(self, frames: int, start_calls: int) -> list:
        """``start_calls`` free frames, each state after them captured,
        then the rest of the free frames and one whole grab cycle, so that
        the window starts with a grab."""
        after = []
        for _ in range(start_calls):
            self.frame()
            after.append((1, self.scene.capture()))
        while self.phase % (self.drag + self.free) or frames > 0:
            self.frame()
            frames -= 1
        return after

    def window(self, seconds: float, at: list, traced: bool = False) -> Window:
        w = Window()
        at = list(at)
        t0 = time.perf_counter()
        try:
            first = True
            while True:
                now = time.perf_counter() - t0
                last = now >= seconds
                due = bool(at) and now >= at[0]
                if due:
                    at.pop(0)
                self.frame(w, sample=first or due or last, traced=traced)
                first = False
                if last:
                    break
            w.finite = bool(np.isfinite(self.last).all())
        except Exception as e:  # a frame that raises is a failed frame
            w.error = "".join(traceback.format_exception_only(e)).strip()
        w.wall_s = time.perf_counter() - t0
        return w
