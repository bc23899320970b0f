"""Interactive viewer server (counterpart of ``tetsim_tpu/viewer/server.py``):
the simulation loop runs here, on the device, and the thin WebGL2 client
``tetsim_tpu/viewer/static/index.html`` (read by path, so both packages
serve the same page) renders whatever the server exports and sends grab
rays back.

Every body in the World is rendered: ``Body`` and ``PackedGridBody``, the
flat batches (``BatchedBody``, ``GridBodyBatch``), the fused batches
(``FusedGSBody``, ``FusedPolarBody``, ``OrderedGSBody``) and the dense
column batch (``DenseBody``).  Geometry is
concatenated into one set of buffers with per-body index offsets; a grab
ray goes to the nearest particle across all bodies.

Protocol (HTTP/1.1, standard library only), byte for byte the JAX
server's:

  GET  /            the client page
  GET  /mesh        static geometry: a JSON header line, then little-endian
                    u32 triangles and edges
  GET  /state       per frame: a JSON header line, then f32 surface
                    vertices, normals and the streamed particle positions
  GET  /diag        World.diagnostics() as JSON
  POST /grab        {"action": "start" | "move", "origin": [..], "dir": [..]}
                    or {"action": "end"}
  POST /params      {"gravity": -9.81, "num_substeps": 5, "normals": ...}
  POST /reset       every body back to its first state
  POST /shutdown    stop the sim thread and the server

Header lines are padded so the binary payload starts 4-byte aligned.  A
body with a surface and no wireframe streams no particles.  The sim thread
steps the world, adapting the frames per iteration to keep real time, and
starts each frame's export with non-blocking copies into pinned host
memory behind a CUDA event; the blob of the frame before is assembled
while the device works.  All device work runs on the sim thread under the
lock, except the ``/diag`` readback.  An exception on the sim thread stops
it and is reported in every later ``/state`` header and ``/diag`` answer,
for the client's red overlay; it is never swallowed and nothing falls back
to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .._compile import TPU_PKG_DIR
from ..kernels.batch import FusedBatch
from ..kernels.polar_fused import FusedPolarBody
from ..mesh import replicate_mesh
from ..params import PhysicsParams
from ..solvers.polar_grid import quats_from_kernel, unplanes
from ..spans import EXPORT, EXPORT_POSITIONS, span
from ..state import Controls
from ..world import (BATCHES, BatchedBody, Body, DenseBody, GridBodyBatch,
                     PackedGridBody, World, _POLAR_ENGINES, _Surface,
                     _surface_render_data, _surface_render_data_rotated)

_STATIC = os.path.join(TPU_PKG_DIR, "viewer", "static")


def _pad_header(hdr: bytes) -> bytes:
    """Pad a JSON header line (spaces before the newline) so the binary
    payload starts 4-byte aligned, as the client's typed-array views need."""
    pad = (-(len(hdr) + 1)) % 4
    return hdr + b" " * pad + b"\n"


def _patch_blob_error(blob: bytes, err: str) -> bytes:
    """Add an ``error`` field to an assembled state blob's header, padded
    again so the payload stays aligned (the last good frame keeps serving,
    now carrying the error)."""
    nl = blob.index(b"\n")
    diag = json.loads(blob[:nl])
    diag["error"] = err
    return _pad_header(json.dumps(diag).encode()) + blob[nl + 1:]


def _nearest_to_ray(pos, origin, direction):
    """Picking on the device: (particle id, depth along the ray, distance
    to the ray) of the particle nearest to the ray, in front of its
    origin.  Three tensors on pos's device."""
    rel = pos - origin
    t = rel @ direction  # depth of each particle along the ray
    perp = rel - t[:, None] * direction
    d2 = (perp * perp).sum(dim=-1)
    d2 = torch.where(t > 0.0, d2, torch.inf)  # only in front of the camera
    i = torch.argmin(d2)
    return i.to(torch.int32), t[i], torch.sqrt(d2[i])


def _to_host_async(a: torch.Tensor) -> torch.Tensor:
    """Start a device-to-host copy: into pinned memory without blocking on
    CUDA (read it after the export's event), a copy on the CPU."""
    if a.device.type != "cuda":
        return a.clone()
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    host.copy_(a, non_blocking=True)
    return host


class _View:
    """Render and interaction adapter over one ``world.bodies`` entry."""

    def __init__(self, body):
        self.body = body
        self._grab_sub = None  # batch member of an active grab
        self._grab_pid = None  # host mirror of the active grab's id
        self._packed_grid = isinstance(body, PackedGridBody)
        if isinstance(body, (Body, PackedGridBody)):
            self.kind = "body"
            self.n_particles = body.mesh.num_particles
            self.surface = body._surface
            self.edges = body.mesh.edges
            self._state0 = None if self._packed_grid else body.state
            if self.surface is not None:
                if self._packed_grid:
                    body.enable_render_export(self.surface.skin_ids,
                                              self.surface.skin_w,
                                              self.surface.tris)
                else:
                    body.enable_render_export()
        elif isinstance(body, (BatchedBody, GridBodyBatch)):
            self.kind = "batched"
            self.n_particles = body.flat_mesh.num_particles
            self.surface = body._surface
            self.edges = body.flat_mesh.edges
            if self.surface is not None:
                body.enable_render_export()
        elif isinstance(body, (FusedBatch, DenseBody)):
            self.kind = "packed"  # the fused and the dense batches
            self._n_per = body.mesh.num_particles
            flat = replicate_mesh(body.mesh, body.num_bodies)
            self.n_particles = flat.num_particles
            self.surface = (_Surface(flat, body.device)
                            if flat.vis_tet_ids is not None else None)
            self.edges = flat.edges
        else:
            raise ValueError(
                f"viewer cannot render body of type {type(body).__name__}")
        if self.kind != "body":
            self._state0 = tuple(
                None if getattr(body, k, None) is None
                else getattr(body, k).clone()
                for k in ("pos", "prev_pos", "vel", "quats"))
        self.n_vis = 0 if self.surface is None else int(self.surface.skin_w.shape[0])
        self.n_tris = 0 if self.surface is None else int(self.surface.tris.shape[0])
        self.n_edges = 0 if self.edges is None else int(self.edges.shape[0])

    @property
    def streams_particles(self) -> bool:
        """Whether the client draws from this view's particle buffer: only
        wireframes and surface-less point clouds read it, so a surfaced,
        edge-less body streams its boundary vertices alone."""
        return self.n_edges > 0 or (self.n_tris == 0 and self.n_edges == 0)

    # -- per-frame data ------------------------------------------------------
    def pos_device(self) -> torch.Tensor:
        """Flat [n_particles, 3] positions on the device."""
        b = self.body
        if self.kind == "body":
            return b.pos_device() if self._packed_grid else b.state.pos
        if isinstance(b, GridBodyBatch):
            return unplanes(b.pos).reshape(-1, 3)
        if isinstance(b, DenseBody):  # [N, 3, B] columns
            return b.pos.movedim(-1, 0).reshape(-1, 3)
        return b.pos.reshape(-1, 3)

    def quats_device(self):
        """Per-tet quaternions in this view's flat tet numbering, or None
        where the body carries no shape-matching rotation (the Neo-Hookean
        family, the packed grid layout)."""
        b = self.body
        if self.kind == "body":
            if self._packed_grid or b.engine not in _POLAR_ENGINES:
                return None
            return b.state.quats
        if isinstance(b, GridBodyBatch):
            return None if b.quats is None else \
                quats_from_kernel(b.quats).reshape(-1, 4)
        if isinstance(b, FusedPolarBody):  # BatchedBody too
            return b.quats.reshape(-1, 4)
        return None

    # -- interaction -----------------------------------------------------------
    def grab_start(self, pid: int, point):
        self._grab_pid = pid
        b = self.body
        if self.kind == "body":
            b.controls = Controls(
                grab_id=torch.tensor(pid, dtype=torch.int32, device=b.device),
                grab_pos=torch.as_tensor(np.asarray(point, np.float32)).to(
                    b.device))
        elif self.kind == "batched":
            self._grab_sub = b.grab_particle(pid, point)
        else:
            self._grab_sub = pid // self._n_per
            b.set_grab(self._grab_sub, pid % self._n_per, point)

    def grab_move(self, point):
        if self.kind == "body":
            self.body.move_grabbed(point)
        elif self._grab_sub is not None:
            self.body.move_grabbed(self._grab_sub, point)

    def grab_end(self):
        if self.kind == "body":
            self.body.end_grab()
        elif self._grab_sub is not None:
            self.body.end_grab(self._grab_sub)
        self._grab_sub = None
        self._grab_pid = None

    def grabbed_id(self) -> int:
        """The grabbed particle (view-local flat id) or -1, from the host
        mirror of the last grab: reading the device's would sync."""
        return -1 if self._grab_pid is None else int(self._grab_pid)

    def reset(self):
        b = self.body
        if self.kind == "body":
            if self._packed_grid:
                b.reset()
            else:
                b.state = self._state0
                b.end_grab()
        else:
            for k, v in zip(("pos", "prev_pos", "vel", "quats"), self._state0):
                if v is not None:
                    setattr(b, k, v.clone())
            for i in range(b.num_bodies):
                b.end_grab(i)
            if isinstance(b, GridBodyBatch):
                b.last_diag = None
        self._grab_sub = None


class ViewerServer:
    """Runs ``world`` at a fixed frame rate in a background thread and
    serves the viewer protocol.  Interaction is applied between frames
    under a lock, so the sim thread owns all stepping."""

    def __init__(self, world: World, host: str = "127.0.0.1",
                 port: int = 8787, fps: float = 60.0,
                 grab_radius: float = 0.35):
        if not world.bodies:
            raise ValueError("world has no bodies")
        self.world = world
        self.views = [_View(b) for b in world.bodies]
        self.host, self.port = host, port
        self.frame_dt = 1.0 / fps
        self.grab_radius = grab_radius
        self.frame = 0
        self.last_step_ms = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._grab_depth = None
        self._grab_view: _View | None = None
        self._sim_thread = None
        self._cached_state: bytes | None = None
        self._httpd = None
        self.sim_error: str | None = None  # set once if the sim thread dies
        self._last_diag: dict | None = None  # last good /diag (error path)
        # "smooth" recomputes normals from the deformed surface (the
        # reference CPU path); "rotated" rotates the rest normals by each
        # tet's quaternion (its GPU path) where a body has them
        self.normals_mode = "smooth"
        self._n_vis = sum(v.n_vis for v in self.views)
        self._n_part = sum(v.n_particles for v in self.views
                           if v.streams_particles)

    @property
    def body(self):
        """The world's first body."""
        return self.world.bodies[0]

    # -- static geometry blob ---------------------------------------------
    def mesh_blob(self) -> bytes:
        header = {
            "n_vis": self._n_vis,
            "n_tris": sum(v.n_tris for v in self.views),
            "n_particles": self._n_part,
            "n_edges": sum(v.n_edges for v in self.views),
            # bodies with neither surface nor wireframe: drawn as points
            "point_ranges": [],
        }
        tris_parts, edge_parts = [], []
        vert_off = part_off = 0  # part_off: in the streamed particle buffer
        for v in self.views:
            if v.n_tris:
                tris_parts.append(np.ascontiguousarray(v.surface.tris_np, np.uint32)
                                  + np.uint32(vert_off))
            if v.n_edges:
                edge_parts.append(np.ascontiguousarray(v.edges, np.uint32)
                                  + np.uint32(part_off))
            if not v.n_tris and not v.n_edges:
                header["point_ranges"].append([part_off, v.n_particles])
            vert_off += v.n_vis
            if v.streams_particles:
                part_off += v.n_particles
        tris = (np.concatenate(tris_parts) if tris_parts
                else np.zeros((0, 3), np.uint32))
        edges = (np.concatenate(edge_parts) if edge_parts
                 else np.zeros((0, 2), np.uint32))
        hdr = _pad_header(json.dumps(header).encode())
        return hdr + tris.tobytes() + edges.tobytes()

    # -- per-frame state blob ----------------------------------------------
    def _export_device(self, precomputed=None):
        """Start the frame's export without blocking: returns (diag dict,
        [(vn, parts)] per view as host tensors whose copies are in flight,
        the CUDA event that marks their end or None).  ``precomputed``:
        {view index: [2,S,3] device tensor} from the fused step+export.
        Call with the sim lock held."""
        precomputed = precomputed or {}
        exports = []
        grabbed, off = -1, 0
        for i, v in enumerate(self.views):
            vn = precomputed.get(i)
            pos = None
            if vn is None or v.streams_particles:
                with span(EXPORT):
                    with span(EXPORT_POSITIONS):
                        pos = v.pos_device()
                    if vn is None and v.surface is not None:
                        s = v.surface
                        quats = (v.quats_device()
                                 if self.normals_mode == "rotated" else None)
                        if quats is not None:
                            vn = _surface_render_data_rotated(
                                pos, s.skin_ids, s.skin_w, s.rest_normals,
                                quats, s.vis_tet_ids)
                        else:
                            vn = _surface_render_data(
                                pos, s.skin_ids, s.skin_w, s.tris)
            # the only per-frame particle transfer; surfaced edge-less
            # bodies skip it
            parts = pos if v.streams_particles else None
            exports.append(tuple(None if a is None else _to_host_async(a)
                                 for a in (vn, parts)))
            if grabbed < 0 and v.grabbed_id() >= 0:
                grabbed = off + v.grabbed_id()
            off += v.n_particles
        event = None
        if any(v.body.device.type == "cuda" for v in self.views):
            event = torch.cuda.Event()
            event.record()
        diag = {"frame": self.frame, "step_ms": round(self.last_step_ms, 3),
                "grabbed": grabbed, "normals": self.normals_mode}
        if self.sim_error is not None:
            diag["error"] = self.sim_error
        return diag, exports, event

    @staticmethod
    def _assemble_blob(diag, exports, event) -> bytes:
        """A started export -> the wire blob (waits for its copies)."""
        if event is not None:
            event.synchronize()
        z = [np.zeros((0, 3), np.float32)]
        verts, normals, parts = [], [], []
        for vn, p in exports:
            if vn is not None:
                vn = vn.numpy()
                verts.append(vn[0])
                normals.append(vn[1])
            if p is not None:
                parts.append(p.numpy())
        hdr = _pad_header(json.dumps(diag).encode())
        return (hdr
                + np.concatenate(verts or z).astype("<f4").tobytes()
                + np.concatenate(normals or z).astype("<f4").tobytes()
                + np.concatenate(parts or z).astype("<f4").tobytes())

    def state_blob(self) -> bytes:
        with self._lock:
            export = self._export_device()
        return self._assemble_blob(*export)

    def _error_blob(self) -> bytes:
        """An error-only state blob of the right size, zero geometry, no
        device work: served when the sim thread died before its first
        frame."""
        diag = {"frame": self.frame, "step_ms": 0.0, "grabbed": -1,
                "error": self.sim_error or "sim thread not running"}
        hdr = _pad_header(json.dumps(diag).encode())
        return hdr + bytes(4 * 3 * (2 * self._n_vis + self._n_part))

    # -- interaction (synchronous, under the sim lock) -----------------------
    def grab(self, action: str, origin=None, direction=None) -> dict:
        """Apply a grab action; returns {"grabbed": id or -1}, the id in the
        concatenated particle numbering.  The solver then holds the grabbed
        particle at its target every substep."""
        if action in ("start", "move") and (origin is None or direction is None):
            raise ValueError(
                f"grab {action!r} needs 'origin' and 'dir' (3-vectors)")
        if action in ("start", "move"):
            o = np.asarray(origin, np.float32)
            d = np.asarray(direction, np.float32)
            d = d / max(np.linalg.norm(d), 1e-12)
        if action == "start":
            with self._lock:
                best = None  # (dist, view, pid, depth, global id)
                off = 0
                for v in self.views:
                    pos = v.pos_device()
                    i, t, dist = (float(x) for x in _nearest_to_ray(
                        pos, torch.as_tensor(o).to(pos.device),
                        torch.as_tensor(d).to(pos.device)))
                    if best is None or dist < best[0]:
                        best = (dist, v, int(i), t, off + int(i))
                    off += v.n_particles
                if best is not None and best[0] <= self.grab_radius:
                    _, view, pid, depth, gid = best
                    if self._grab_view is not None:
                        # a second start without an end must not leave the
                        # first body's particle pinned
                        self._grab_view.grab_end()
                    self._grab_depth = depth
                    self._grab_view = view
                    view.grab_start(pid, o + d * depth)
                    return {"grabbed": gid}
            return {"grabbed": -1}
        if action == "move":
            with self._lock:
                if self._grab_depth is not None and self._grab_view is not None:
                    self._grab_view.grab_move(o + d * self._grab_depth)
                    off = 0
                    for v in self.views:
                        if v is self._grab_view:
                            return {"grabbed": off + v.grabbed_id()}
                        off += v.n_particles
            return {"grabbed": -1}
        if action == "end":
            with self._lock:
                self._grab_depth = None
                if self._grab_view is not None:
                    self._grab_view.grab_end()
                    self._grab_view = None
            return {"grabbed": -1}
        raise ValueError(f"unknown grab action {action!r}")

    def set_params(self, updates: dict):
        with self._lock:
            p = self.world.params
            fields = {}
            for k, v in updates.items():
                if k == "normals":  # the viewer's shading, not physics
                    if v not in ("smooth", "rotated"):
                        raise ValueError(
                            f"normals must be 'smooth' or 'rotated', got {v!r}")
                    self.normals_mode = v
                elif k in ("num_substeps", "extract_iters"):
                    fields[k] = int(v)
                elif k in ("world_min", "world_max"):
                    fields[k] = np.asarray(v, np.float32)
                elif k in {f.name for f in dataclasses.fields(PhysicsParams)}:
                    fields[k] = np.float32(v)
                else:
                    raise ValueError(f"unknown param {k!r}")
            self.world.params = dataclasses.replace(p, **fields)

    def reset(self):
        with self._lock:
            for v in self.views:
                v.reset()
            self._grab_depth = None
            self._grab_view = None
        self._cached_state = None

    # -- sim loop ------------------------------------------------------------
    def _step_world(self, frames: int) -> dict:
        """Advance every body ``frames`` frames; bodies with the fused
        step+export give their render data from the same call ({view
        index: [2,S,3]}).  Call with the sim lock held."""
        vns = {}
        params = self.world.params
        for i, v in enumerate(self.views):
            b = v.body
            if getattr(b, "_many_export", None) is not None:
                vns[i] = b.step_many_export(params, frames,
                                            normals=self.normals_mode)
            elif isinstance(b, BATCHES):
                b.step(params, frames)
            else:
                b.step_many(params, frames)
        return vns

    def _run_sim(self):
        batch = 1
        pending = None  # the last iteration's export, copies in flight
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                with self._lock:
                    vns = self._step_world(batch)
                    step_s = time.perf_counter() - t0
                    self.frame += batch
                    export = self._export_device(precomputed=vns)
                # assemble the frame before while this one runs
                if pending is not None:
                    self._cached_state = self._assemble_blob(*pending)
            except Exception as e:  # noqa: BLE001 — reported, never swallowed
                self._record_sim_error(e, pending)
                return
            pending = export
            dt_wall = time.perf_counter() - t0
            # the step alone: dt_wall also holds the export and the blob of
            # the frame before, overlapped with the device on purpose
            self.last_step_ms = step_s * 1e3 / batch
            # adaptive frame batching with hysteresis (grow above 1.2x the
            # frame time, shrink below 0.8x), at most 4 frames per
            # iteration so grabs and params stay responsive
            lag = (dt_wall / batch) / self.frame_dt
            sleep = batch * self.frame_dt - dt_wall
            if lag > 1.2 and batch < 4:
                batch += 1
            elif lag < 0.8 and batch > 1:
                batch -= 1
            if sleep > 0:
                time.sleep(sleep)
        if pending is not None:  # so /state never serves a stale frame
            self._cached_state = self._assemble_blob(*pending)

    def _record_sim_error(self, e: Exception, pending):
        """The sim thread stops on an exception: print its traceback, and
        make every later /state and /diag answer carry a one-line error.
        ``sim_error`` is set last, so /diag never reports the error while
        the cached blob still lacks it."""
        import traceback

        traceback.print_exc()
        err = f"{type(e).__name__}: {e}"[:500]
        print(f"viewer sim thread halted: {err}", file=sys.stderr, flush=True)
        if pending is not None:
            try:
                pending[0]["error"] = err
                self._cached_state = self._assemble_blob(*pending)
                self.sim_error = err
                return
            except Exception:  # noqa: BLE001 — the device may be gone
                pass
        if self._cached_state is not None:
            self._cached_state = _patch_blob_error(self._cached_state, err)
        self.sim_error = err

    # -- http ----------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    with open(os.path.join(_STATIC, "index.html"), "rb") as f:
                        self._send(200, f.read(), "text/html")
                elif self.path == "/mesh":
                    self._send(200, server.mesh_blob())
                elif self.path == "/state":
                    # the sim thread's cached frame; before the first frame
                    # one export on demand, after a death the error blob
                    blob = server._cached_state
                    if blob is None:
                        blob = (server._error_blob()
                                if server.sim_error is not None
                                else server.state_blob())
                    self._send(200, blob)
                elif self.path == "/diag":
                    # after a sim-thread death the device is not touched
                    if server.sim_error is not None:
                        d = dict(server._last_diag or {}, error=server.sim_error)
                    else:
                        d = server.world.diagnostics()
                        server._last_diag = d
                    self._send(200, json.dumps(d).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b'{"error": "bad json"}', "application/json")
                    return
                try:
                    if self.path == "/grab":
                        out = server.grab(msg.get("action", ""),
                                          msg.get("origin"), msg.get("dir"))
                        self._send(200, json.dumps(out).encode(),
                                   "application/json")
                        return
                    elif self.path == "/params":
                        server.set_params(msg)
                    elif self.path == "/reset":
                        server.reset()
                    elif self.path == "/shutdown":
                        # the sim thread finishes its current call first
                        server._stop.set()
                        threading.Thread(target=server._httpd.shutdown,
                                         daemon=True).start()
                    else:
                        self._send(404, b"not found", "text/plain")
                        return
                except (ValueError, TypeError) as e:
                    self._send(400, json.dumps({"error": str(e)}).encode(),
                               "application/json")
                    return
                self._send(200, b'{"ok": true}', "application/json")

        return Handler

    def start(self):
        """Start the sim and HTTP threads; returns once both run."""
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._sim_thread = threading.Thread(target=self._run_sim, daemon=True)
        self._sim_thread.start()
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._sim_thread is not None:
            self._sim_thread.join(timeout=5)

    def serve_forever(self):
        print(f"tetsim viewer: http://{self.host}:{self.port}/")
        try:
            while not self._stop.is_set():
                time.sleep(1)
            self._sim_thread.join(timeout=30)
        except KeyboardInterrupt:
            self.stop()


def main():
    """CLI: python -m tetsim_torch.viewer.server [--engine polar|neohookean]
    [--port 8787] [--host 127.0.0.1] [--substeps N] [--bodies N] (N > 1: a
    draggable flat batch) [--grid NX,NY,NZ --cell C] (a grid_mesh box with
    packed state through the stencil kernels), on the card."""
    import argparse

    from ..mesh import load_dragon
    from ..params import default_cpu_params, default_gpu_params

    ap = argparse.ArgumentParser(description="tetsim_torch interactive viewer")
    ap.add_argument("--engine", default="polar", choices=["polar", "neohookean"])
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--substeps", type=int, default=None)
    ap.add_argument("--bodies", type=int, default=1)
    ap.add_argument("--grid", default=None,
                    help="NX,NY,NZ grid_mesh via the packed stencil kernel")
    ap.add_argument("--cell", type=float, default=0.06)
    args = ap.parse_args()

    params = (default_gpu_params() if args.engine == "polar"
              else default_cpu_params())
    if args.substeps:
        params = dataclasses.replace(params, num_substeps=args.substeps)
    world = World(params)
    if args.grid:
        try:
            dims = tuple(int(x) for x in args.grid.split(","))
        except ValueError:
            ap.error(f"--grid expects NX,NY,NZ integers, got {args.grid!r}")
        if len(dims) != 3 or any(d < 1 for d in dims):
            ap.error("--grid expects exactly three positive integers "
                     f"NX,NY,NZ (e.g. 32,32,32), got {args.grid!r}")
        ext = max(dims) * args.cell
        engine = ("neohookean_grid_pallas" if args.engine == "neohookean"
                  else "polar_grid_pallas")
        world.add_grid_body(
            dims, cell=args.cell,
            origin=(-dims[0] * args.cell / 2, ext * 0.75,
                    -dims[2] * args.cell / 2),
            engine=engine, packed=True, with_surface=True)
    elif args.bodies > 1:
        world.add_body_batch(load_dragon(), args.bodies, engine=args.engine,
                             jitter=0.5)
    else:
        world.add_body(load_dragon(), engine=args.engine)
    ViewerServer(world, host=args.host, port=args.port).start().serve_forever()


if __name__ == "__main__":
    main()
