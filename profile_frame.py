#!/usr/bin/env python3
"""Where a frame of the PyTorch/CUDA port's fused frame kernels spends its
time, on one CUDA card.

    python3 profile_frame.py     # from the repository root, one CUDA card

For each dragon shape it prints one JSON line: the Neo-Hookean kernel
(gs_frame, 5 substeps) through ``FusedGSBody`` on the greedy schedule at
B = 1, 8, 64 and 132 bodies and on the ordered schedule at B = 1 and 8,
the exact-order kernel (gs_ordered, 5 substeps) through ``OrderedGSBody``
(8 bodies, the same ordered schedule in sub-levels of at most 32 tets),
then the polar kernel (polar_frame, 20 substeps) through ``FusedPolarBody`` at
B = 1, 8 and 132, then the grid stencil kernels on the 56^3 box of the scale
workload (1,053,696 tets, 5 substeps, as examples/scale_grid.py) through
``World.add_grid_body(..., packed=True)``: polar_stencil (2 launches per
substep) and nh_stencil (1 per frame), then the pieces kernels on the
987,090-tet blob of the unstructured scale workload (bench.py:
ellipsoid_mesh(68), 2,048 tets per piece, banded lanes, 5 substeps) through
their packed steppers: polar_pieces (1 launch per substep, between the
torch phases of the substep) and nh_pieces (1 per frame, the whole
substep in the kernel):
  host_ms     synced host time per frame: a two-point fit over k1 and k2
              frames, each run ending in a data-dependent sync;
  enqueue_ms  host time per frame to enqueue k2 frames, with no sync;
  event_ms    CUDA-event span per frame over those same k2 frames;
  kernel_us   the kernel's device time per launch, torch.profiler over 20
              frames (null where the profiler records no device time);
  device_ms   the kernels' device time per frame, over the same 20 frames;
  busy_share  device_ms / event_ms: the share of a frame's span in which
              the kernels run;
  glue_device_ms  (pieces rows) the device time per frame of every other
              kernel, the torch phases around the kernel;
  idle_ms     (pieces rows) event_ms less all device time: the span in
              which the card runs nothing;
  bound_us    the least time the card could take for the frame: its
              operations at 67 TFLOP/s FP32 or its bytes (each input read
              once, each output written once) at 3.35 TB/s, whichever is
              longer (bound_by says which), from the kernel module's
              frame_flops and frame_bytes.
Every shape is timed first and profiled after (a torch.profiler session
slows later launches on the host), and the rows are printed then.
Each polar shape is measured with two builds of polar_frame.cu, in the
order A B B A: the shipped build (``polar_fused.NVCC_FLAGS``: nvcc's
default, which contracts a multiply and an add into one FMA) and a
``-fmad=false`` build, which rounds every product before it is added, as
the plain twin does.  For each
build it then prints the kernel against its plain twin from 8 jittered
dragons with 3 pinned particles and a grab (chip_smoke.py phase 6's first
case) after 1 and 3 frames, beside the build's own spread from positions
1 ulp apart, and the largest difference between the two builds.
The card's name, power limit, SM clock and power draw are printed before
and after.  It exits non-zero where CUDA is unavailable.

    python3 profile_frame.py --parent DIR

holds the dragon frame kernels against an earlier version of the port
instead: DIR holds that version's ``tetsim_torch/`` and
``tetsim_tpu/assets/`` (for example ``git archive <commit> tetsim_torch
tetsim_tpu/assets`` unpacked into a directory that .gitignore lists), which
is imported under another name and builds its own kernels into its own
``_build/``.  For gs_frame ordered B = 1, greedy B = 1 and 8 (5 substeps),
polar_frame B = 1, 8 and 132 (20 substeps), gs_ordered B = 8, nh_stencil
and polar_stencil on the packed 56^3 box (5 substeps) and polar_pieces on
the packed 987k blob (5 substeps) it times the earlier version (A) and
this one (B) in the order A B B A, each through its own FusedGSBody /
FusedPolarBody / OrderedGSBody / make_frame_stepper / make_pieces_stepper
(not through World, whose engine names resolve to this version's modules),
in the columns above, and says whether the two give the same bits after 3
frames from the same start; and gs_levels through each side's
``levels_frame`` on grid_mesh(20, 20, 20) at B = 1 and 8 ("large nh 20^3
B=1", "B=8"; 5 substeps) and K3s through each side's
``make_nh_sharded_stepper`` on its ``SlabMesh(4)`` ("slab nh 56^3 x4",
the box at cell 0.05, 5 substeps); K3 through each side's
``nh_stencil.grid_frame`` with the volume error ("grid nh 56^3 vol_err":
the box at cell 0.05 from velocities seeded in +-0.1; "grid nh 9x7x5
B=3": three odd boxes side by side, two of them holding a grab; 5
substeps, the volume error among the bits); K4a through each side's
``make_grid_sharded_stepper`` on its ``SlabMesh(d)`` ("slab polar 56^3 x1",
"x2", "x4": the 56^3 box at cell 0.02 from velocities seeded in +-0.1, 5
substeps); nh_pieces through each side's ``make_nh_pieces_stepper`` on
the 987k blob ("pieces nh 987k" banded, "pieces nh 987k default" in the
default lane layout, 5 substeps); polar_jacobi through each side's
``jacobi_frame`` on grid_mesh(20, 20, 20) at B = 1 and 8 ("large polar
20^3 B=1", "B=8"; jittered bodies, body 0 and 5 holding a corner 2 cm
up, 5 substeps) and one body from rest through each side's
``World.step``, the user's path (``Body.step`` and its glue around
``jacobi_frame``: "large polar 20^3 World.step", 5 substeps); and K9
through each side's ``roofline.extract_rotation``
("K9 1M lanes": a frame is one pass over ``random_planes``' 1,048,576
lanes, a run of k frames one launch of k passes, so kernel_us is per
launch of 20 passes and the bits are compared after 4 passes); and the
dense engine on the dragon through each side's ``solvers.dense.step_frame``
at B = 8 and 128 ("dense B=8", "dense B=128": jittered 0.5, body 5 holding
a particle 5 cm up, 5 substeps; kernel_us and device_ms over every kernel
of the frame, per_kernel by name; the bits also from a start with a NaN,
then an inf, planted in bodies 0 and 1, NaN masks compared), and on
chip_smoke.py phase 27's two bodies past one block's shared memory, the
kernel's global form at the plan's cluster per body: 19,372 particles (L
= 1) at B = 8, 1 and 128 ("dense 19k B=8", "dense 19k B=1", "dense 19k
B=128": one block a body) and 19,376 (L = 6) at B = 8 and 1 ("dense 19k
L=6 B=8", "dense 19k L=6 B=1"), and the dragon at B = 8 forced onto the
global form through each side's ``kernels.dense_frame.dense_frame``,
greedy and ordered ("dense global B=8", "dense global ordered B=8"); a
parent older than the global form refuses them.
kernel_us is per launch (nh_stencil:
50 per substep in the first design, one per frame since; polar_pieces: 2
per substep in the first design, one since; gs_levels: L + 2 per substep
in the first design, one per frame since; K3s: 50 per substep and 12
plane copies per neighbour pair in the first design, one per frame
since; K4a: 3 per substep and the halo's plane copies and adds in the
first design, 2 per substep since; nh_pieces: one sweep per substep
between torch ops in the first design, one launch per frame that carries
the whole substep since; polar_jacobi: 2 per substep in the first
design, one cooperative launch per frame since); where a shape runs several
kernels, per_kernel gives each one's launches per frame and device us per
launch; the polar_pieces rows add solve_event_ms, the solve alone by CUDA
events on the packed state's predicted planes.  Before the timings it
prints, for each side's polar_stencil and polar_pieces library, each
kernel's registers, static shared and local (spill) bytes per thread
(cuobjdump -res-usage) and the threads an SM holds at its launch's block
size (and polar_jacobi's blocks per SM and cooperative grid).  ``--only
NAME ...`` times only the shapes of those names (and, with --variants or
--phases, runs only the entries of VARIANT_RUNS / PHASE_RUNS so named).
``--pairs N`` repeats A B B A N times for each shape (default 1).

    python3 profile_frame.py --variants

times the build-time sizes of the two polar tet-pass kernels in the same
columns: polar_stencil at strips of 32 and 64 cubes per pass-A block
(``-DPOLAR_STENCIL_STRIP``) on the packed 56^3 box, A B B A, and
polar_pieces at 256, 384 and 512 threads per block
(``-DPOLAR_PIECES_THREADS``) on the packed 987k blob, A B C C B A, with
each build's resource usage ("K4 K6").

    python3 profile_frame.py --phases

prints where a substep of polar_frame goes: a build with
``-DPOLAR_FRAME_PHASES`` has block 0 of each launch count the SM cycles of
predict, phase A (the tets), the first cluster barrier, phase B (the
particles and the replica stores) and the second barrier, each phase
ended by a __syncthreads() that the shipped build does not have; one
dragon at each cluster size, 8 dragons and 132 dragons at the size they
take, 20 frames of 20 substeps after 3 to warm up.  Then gs_ordered's
level walk: SM cycles per sub-level on block 0 (``-DGS_ORDERED_PHASES``, 8
dragons, 20 frames after 3) and the SASS instructions (cuobjdump) of the
kernel and of one solve per lane (and of the earlier version's kernel with
--parent); then nh_stencil on the 56^3 box at its grid of one block per SM
and at two per SM: SM cycles per substep on block 0 of its particle
phases, its 48 colour phases and its 2 grid barriers, and its 47
neighbour waits between colours (how many found a flag not yet ready at
the first poll, SM cycles each; ``-DNH_STENCIL_PHASES``), and the us of
one grid barrier alone; then
gs_levels on grid_mesh(20, 20, 20), one body at every cluster size the
card runs and 8 bodies: SM cycles on block 0 per substep of its particle
phases, per level and per cluster barrier (``-DGS_LEVELS_PHASES``); then
polar_jacobi on grid_mesh(20, 20, 20) at B = 1 and 8: SM cycles on block
0 of its predict phase, per substep of its tet pass and its particle pass,
per grid barrier (``-DPOLAR_JACOBI_PHASES``), and one grid barrier alone;
then K9's instruction stream ("K9") on 1,048,576 lanes: its SASS per
iteration by class (a probe build, ``-DEXTRACT_ROTATION_PROBE``: all of
the code, and the fast path that no slow path leaves, ``fast_path``), its
ms per pass by CUDA events and the issue floor of its fast path at the SM
clock read while it runs; then dense_frame's cluster walk ("dense_frame",
``-DDENSE_FRAME_PHASES``): SM cycles on block 0 per substep of its
particle passes, per level and per barrier, the instrumented frame's ms
and the spread of its blocks, on the two bodies past one block's shared
memory at B = 1 and 8 at the plan's cluster, and on 8 greedy dragons
forced onto it at a cluster of 2 blocks, beside each batch's ms on one
block a body.
"""
import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import bound, max_diff

PIECES_SHAPES = (("pieces polar 987k", "polar_pieces", "polar_pieces_", 4, 24),
                 ("pieces nh 987k", "nh_pieces", "nh_pieces_", 4, 24))
GRID_DIMS = (56, 56, 56)  # the scale box: 1,053,696 tets
GRID_BOX = dict(cell=0.02, origin=(-0.56, 0.5, -0.56))
GRID_SHAPES = (("grid polar 56^3", "polar_grid_pallas", "polar_grid_", 20, 120),
               ("grid nh 56^3", "neohookean_grid_pallas", "nh_grid_", 20, 120))
SHAPES = (("B=1 greedy", 1, "greedy", 50, 450),
          ("B=8 greedy", 8, "greedy", 50, 450),
          ("B=64 greedy", 64, "greedy", 50, 450),
          ("B=132 greedy", 132, "greedy", 50, 450),
          ("B=1 ordered", 1, "ordered", 20, 80),
          ("B=8 ordered", 8, "ordered", 20, 80),
          ("gs_ordered B=8", 8, "exact", 20, 80),
          ("polar B=1", 1, None, 20, 120),
          ("polar B=8", 8, None, 20, 120),
          ("polar B=132", 132, None, 20, 120))
PROFILED_FRAMES = 20
PIECES_LANES = (1152, 2048)  # rp, rt of the 987k blob at 2,048 tets per piece
# the builds --variants compares, in the order A B B A (A B C C B A)
STRIPS = (("-DPOLAR_STENCIL_STRIP=32",), ("-DPOLAR_STENCIL_STRIP=64",))
PIECES_THREADS = (("-DPOLAR_PIECES_THREADS=256",),
                  ("-DPOLAR_PIECES_THREADS=384",),
                  ("-DPOLAR_PIECES_THREADS=512",))
UNCONTRACTED = ("-fmad=false",)  # every product rounded before it is added


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synced_run(step, state_sum, k) -> float:
    t0 = time.perf_counter()
    step(k)
    float(state_sum())
    return time.perf_counter() - t0


def kernel_device_time(step, kernel):
    """(device us per launch, device ms per frame, {kernel: [launches per
    frame, device us per launch]}) of the kernels whose names contain
    ``kernel`` (None: every kernel on the card), torch.profiler over
    PROFILED_FRAMES frames; (None, None, {}) where it records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(PROFILED_FRAMES)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if (e.device_type == DeviceType.CUDA if kernel is None
                  else kernel in e.key)]
    launches = sum(e.count for e in events)
    device_us = sum(e.self_device_time_total for e in events)
    if not (launches and device_us):
        return None, None, {}
    each = {(e.key[:60] if kernel is None else
             re.search(rf"\w*{kernel}\w*", e.key).group(0)): [
        e.count / PROFILED_FRAMES, e.self_device_time_total / e.count]
        for e in events} if kernel != "" else {}
    return device_us / launches, device_us / PROFILED_FRAMES / 1e3, each


def host_fit(step, state_sum, k1, k2) -> float:
    """Synced host seconds per frame: a two-point fit over k1 and k2 frames
    after a one-frame warm-up."""
    synced_run(step, state_sum, 1)
    return (synced_run(step, state_sum, k2)
            - synced_run(step, state_sum, k1)) / (k2 - k1)


def measure(body, params, k1, k2, kernel, flops, nbytes, state_sum=None,
            build=contextlib.nullcontext):
    """Times a shape now and returns (row, profile): ``profile()``, called
    after every shape was timed, adds the device columns under ``build()``
    and returns the row.  A torch.profiler session leaves later launches
    slower on the host (``main`` re-times the pieces rows after all
    sessions to show it), so no timing follows one."""
    def step(k):
        body.step(params, k)

    if state_sum is None:
        def state_sum():
            return body.pos.sum()

    host_s = host_fit(step, state_sum, k1, k2)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    step(k2)
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / k2
    bound_ms, bound_by = bound(flops, nbytes)
    row = {
        "host_ms": host_s * 1e3, "enqueue_ms": enqueue_s * 1e3 / k2,
        "event_ms": event_ms, "substeps_per_s": params.num_substeps / host_s,
        "bound_us": bound_ms * 1e3, "bound_by": bound_by,
    }

    def profile():
        with build():
            kernel_us, device_ms, each = kernel_device_time(step, kernel)
        row.update(kernel_us=kernel_us, device_ms=device_ms,
                   busy_share=device_ms / event_ms if device_ms else None)
        if len(each) > 1:
            row["per_kernel"] = each
        return row

    return row, profile


@contextlib.contextmanager
def flags_build(mod, flags):
    """Inside, the kernel module ``mod`` (its ``NVCC_FLAGS``) launches the
    build with these nvcc flags, which it yields built."""
    shipped = mod.NVCC_FLAGS
    mod.NVCC_FLAGS = flags
    try:
        yield mod.library()
    finally:
        mod.NVCC_FLAGS = shipped


def build_name(flags) -> str:
    return " ".join(flags) if flags else "contracted"


def polar_agreement(tt, polar_fused, dragon, builds):
    """Each build against the plain twin after 1 and 3 frames at 20
    substeps, and its spread from positions 1 ulp apart."""
    params = tt.default_gpu_params()
    top = np.argsort(-dragon.verts[:, 1])[:3].tolist()
    body = polar_fused.FusedPolarBody(dragon, 8, jitter=0.2, pinned=top)
    body.set_grab(3, 100, body.pos[3, 100].cpu().numpy()
                  + np.float32([0, 0.05, 0]))
    args = (body.arrays, params, body.grab_id, body.grab_pos)

    def run(frame, pos):
        out, vel, quats = [], body.vel, body.quats
        for _ in range(3):
            pos, _, vel, quats = frame(pos, vel, quats, *args)
            out.append((pos, vel, quats))
        torch.cuda.synchronize()
        return out[0], out[2]

    plain = run(polar_fused.polar_frame_reference, body.pos)
    ulp = torch.nextafter(body.pos, torch.full_like(body.pos, 10.0))
    last = {}
    for flags in builds:
        with flags_build(polar_fused, flags):
            got = run(polar_fused.polar_frame, body.pos)
            moved = run(polar_fused.polar_frame, ulp)
        last[flags] = got[1][0]
        line = {}
        for i, frames in enumerate((1, 3)):
            line[f"{frames} frame(s)"] = {
                "dpos": max_diff(got[i][0], plain[i][0]),
                "dquat": max_diff(got[i][2], plain[i][2]),
                "dvel": max_diff(got[i][1], plain[i][1]),
                "ulp_spread": max_diff(got[i][0], moved[i][0])}
        print(f"polar_frame [{build_name(flags)}] vs plain, B=8 jittered, 3 "
              f"pinned, grab on body 3:", json.dumps(line), flush=True)
    a, b = builds
    print(f"polar_frame [{build_name(a)}] vs [{build_name(b)}] after 3 "
          f"frames: max|dpos| {max_diff(last[a], last[b]):.3e}", flush=True)


class _Frames:
    """A PackedGridBody as ``measure`` drives a batch: step(params, k)."""

    def __init__(self, body):
        self.body = body

    def step(self, params, k):
        for _ in range(k):
            self.body.step(params)


def grid_profile(tt, pending):
    """The 56^3 box of each grid kernel, packed, 5 substeps per frame."""
    from tetsim_torch.kernels import nh_stencil, polar_stencil

    params = tt.PhysicsParams(num_substeps=5)
    for name, engine, kernel, k1, k2 in GRID_SHAPES:
        world = tt.World(params)
        body = world.add_grid_body((56, 56, 56), cell=0.02,
                                   origin=(-0.56, 0.5, -0.56), engine=engine,
                                   packed=True)
        mod = polar_stencil if engine.startswith("polar") else nh_stencil
        arr = body.arrays
        nbytes = (mod.frame_bytes(arr, 1, 1) if mod is polar_stencil
                  else mod.frame_bytes(arr, params, 1, 1))
        row, profile = measure(_Frames(body), params, k1, k2, kernel,
                               mod.frame_flops(arr, params, 1), nbytes,
                               state_sum=lambda b=body: b.pos_device().sum())
        row["ms_per_substep"] = row["event_ms"] / params.num_substeps
        pending.append((name, profile))


class _Packed:
    """A pieces stepper's packed state as ``measure`` drives a batch."""

    def __init__(self, tt, stepper, state, params):
        pack, self._step, _, _ = stepper
        self.packed = pack(state, params)
        self.controls = tt.Controls.none("cuda")

    def step(self, params, k):
        for _ in range(k):
            self.packed = self._step(self.packed, params, self.controls)


def pieces_profile(tt, pending):
    """bench.py's 987,090-tet blob through each pieces engine's packed
    stepper, 5 substeps per frame.  Returns a host re-timing per row, for
    after the profiler sessions."""
    from chip_smoke import BLOB, PIECES_TPP, pieces_engines

    params = tt.PhysicsParams(num_substeps=5)
    mesh = tt.ellipsoid_mesh(**BLOB)
    engines = {e.name: e for e in pieces_engines()}
    retimes = []
    for name, engine, kernel, k1, k2 in PIECES_SHAPES:
        e = engines[engine]
        arr = e.build(mesh, tets_per_piece=PIECES_TPP, boundary_prefix=True,
                      device="cuda")
        body = _Packed(tt, e.make(arr), tt.init_state(mesh, "cuda"), params)
        row, profile = measure(body, params, k1, k2, kernel,
                               e.mod.frame_flops(arr, params),
                               e.mod.frame_bytes(arr, params),
                               state_sum=lambda b=body: b.packed[0].sum())
        row["ms_per_substep"] = row["event_ms"] / params.num_substeps

        def glue(profile=profile, body=body):
            row = profile()
            _, all_ms, _ = kernel_device_time(
                lambda k: body.step(params, k), "")
            row["glue_device_ms"] = all_ms - row["device_ms"]
            row["idle_ms"] = row["event_ms"] - all_ms
            return row

        pending.append((name, glue))
        retimes.append((name, lambda body=body, k1=k1, k2=k2: host_fit(
            lambda k: body.step(params, k), lambda: body.packed[0].sum(),
            k1, k2)))
    return retimes


AB_SHAPES = (("gs ordered B=1", "gs", 1, "ordered", 20, 80),
             ("gs greedy B=1", "gs", 1, "greedy", 50, 450),
             ("gs greedy B=8", "gs", 8, "greedy", 50, 450),
             ("polar B=1", "polar", 1, None, 20, 120),
             ("polar B=8", "polar", 8, None, 20, 120),
             ("polar B=132", "polar", 132, None, 20, 120),
             ("gs_ordered B=8", "ordered", 8, None, 20, 80),
             ("grid nh 56^3", "grid", 1, None, 20, 120),
             ("grid nh 56^3 vol_err", "gridbatch", 1, GRID_DIMS, 20, 120),
             ("grid nh 9x7x5 B=3", "gridbatch", 3, (9, 7, 5), 50, 450),
             ("grid polar 56^3", "gridpolar", 1, None, 20, 120),
             ("pieces polar 987k", "pieces", 1, None, 4, 24),
             ("large nh 20^3 B=1", "large", 1, None, 10, 50),
             ("large nh 20^3 B=8", "large", 8, None, 10, 50),
             ("slab nh 56^3 x4", "slab", 4, None, 5, 25),
             ("slab polar 56^3 x1", "slabpolar", 1, None, 5, 25),
             ("slab polar 56^3 x2", "slabpolar", 2, None, 5, 25),
             ("slab polar 56^3 x4", "slabpolar", 4, None, 5, 25),
             ("pieces nh 987k", "piecesnh", 1, True, 4, 24),
             ("pieces nh 987k default", "piecesnh", 1, False, 4, 24),
             ("large polar 20^3 B=1", "largepolar", 1, None, 10, 50),
             ("large polar 20^3 B=8", "largepolar", 8, None, 10, 50),
             ("large polar 20^3 World.step", "worldpolar", 1, None, 10, 50),
             ("K9 1M lanes", "k9", 1, None, 16, 64),
             ("dense B=8", "dense", 8, None, 10, 60),
             ("dense B=128", "dense", 128, None, 10, 60),
             ("dense 19k B=8", "dense", 8, "19k", 10, 60),
             ("dense 19k L=6 B=8", "dense", 8, "19k L=6", 10, 60),
             ("dense 19k B=1", "dense", 1, "19k", 10, 60),
             ("dense 19k L=6 B=1", "dense", 1, "19k L=6", 10, 60),
             ("dense 19k B=128", "dense", 128, "19k", 4, 24),
             ("dense global B=8", "dense", 8, "global", 10, 60),
             ("dense global ordered B=8", "dense", 8, "ordered global", 4,
              24))
LARGE_DIMS = (20, 20, 20)  # 9,261 particles: over one block's shared memory
LARGE_BOX = dict(cell=0.05, origin=(-0.5, 0.3, -0.5))
SLAB_BOX = dict(cell=0.05, origin=(-1.4, 0.1, -1.4))  # NH collapses at 0.02
AB_KERNELS = {"gs": ("kernels.gs_fused", "gs_frame_kernel"),
              "polar": ("kernels.polar_fused", "polar_frame_kernel"),
              "ordered": ("kernels.gs_ordered", "gs_ordered_kernel"),
              "grid": ("kernels.nh_stencil", "nh_grid_"),
              "gridbatch": ("kernels.nh_stencil", "nh_grid_"),
              "gridpolar": ("kernels.polar_stencil", "polar_grid_"),
              "pieces": ("kernels.polar_pieces", "polar_pieces_"),
              "large": ("kernels.gs_levels", "gs_levels_"),
              "slab": ("kernels.nh_stencil", "nh_"),
              "slabpolar": ("kernels.polar_stencil", "polar_"),
              "piecesnh": ("kernels.nh_pieces", "nh_pieces_"),
              "largepolar": ("kernels.polar_jacobi", "polar_jacobi_"),
              "worldpolar": ("kernels.polar_jacobi", "polar_jacobi_"),
              "k9": ("roofline", "extract_rotation_kernel"),
              "dense": ("solvers.dense", None)}


class _Levels:
    """B jittered bodies of one large mesh stepped by a version's
    ``gs_levels.levels_frame``, as ``measure`` drives a batch."""

    def __init__(self, mod, arrays, mesh, b):
        rng = np.random.RandomState(b)
        rest = np.float32(mesh.verts)
        self.mod, self.arrays = mod, arrays
        self.pos = torch.tensor(rest + rng.normal(0, 0.002, (b,) + rest.shape)
                                .astype(np.float32), device="cuda")
        self.vel = torch.zeros_like(self.pos)
        self.prev = self.pos
        self.vol_err = None
        self.gid = torch.full((b, 1), -1, dtype=torch.int32, device="cuda")
        self.gpos = torch.zeros((b, 1, 3), device="cuda")

    def step(self, params, k):
        for _ in range(k):
            self.pos, self.prev, self.vel, self.vol_err = \
                self.mod.levels_frame(self.pos, self.vel, self.arrays, params,
                                      self.gid, self.gpos)


class _GridBatch:
    """B Neo-Hookean boxes of one size stepped by a version's
    ``nh_stencil.grid_frame`` with the volume error, as ``GridBodyBatch``
    steps them (World's registry names this version's modules): side by
    side along x from velocities seeded in +-0.1, body 0 holding particle 0
    2 cm up and, of several, the last body its last particle 2 cm out."""

    def __init__(self, mod, arrays, mesh, b):
        rng = np.random.RandomState(b)
        verts = np.float32(mesh.verts)
        shift = np.zeros((b, 1, 3), np.float32)
        shift[:, 0, 0] = np.arange(b) * 1.5 * np.ptp(verts[:, 0])
        self.mod, self.arrays = mod, arrays
        self.pos = torch.tensor(verts + shift, device="cuda").transpose(
            1, 2).contiguous()
        self.vel = torch.tensor(rng.uniform(-0.1, 0.1, self.pos.shape)
                                .astype(np.float32), device="cuda")
        self.prev, self.vol_err = self.pos, None
        self.gid = torch.full((b, 1), -1, dtype=torch.int32, device="cuda")
        self.gpos = torch.zeros((b, 1, 3), device="cuda")
        last = mesh.num_particles - 1
        for body, pid, lift in ((0, 0, (0.0, 0.02, 0.0)),
                                (b - 1, last, (0.02, 0.0, 0.0)))[:b]:
            self.gid[body, 0] = pid
            self.gpos[body, 0] = self.pos[body, :, pid] + torch.tensor(
                lift, device="cuda")

    def step(self, params, k):
        for _ in range(k):
            self.pos, self.prev, self.vel, self.vol_err = self.mod.grid_frame(
                self.pos, self.vel, self.arrays, params, self.gid, self.gpos,
                vol_err=True)


class _Jacobi(_Levels):
    """B jittered polar bodies of one large mesh stepped by a version's
    ``polar_jacobi.jacobi_frame``, body 0 (and body 5 of 8) holding a
    corner 2 cm up."""

    def __init__(self, mod, arrays, mesh, b):
        super().__init__(mod, arrays, mesh, b)
        self.quats = torch.zeros((b, mesh.num_tets, 4), device="cuda")
        self.quats[..., 3] = 1.0
        for body, pid in ((0, 0), (5, mesh.num_particles - 1))[:1 + (b > 5)]:
            self.gid[body, 0] = pid
            self.gpos[body, 0] = self.pos[body, pid] + torch.tensor(
                [0.0, 0.02, 0.0], device="cuda")

    def step(self, params, k):
        for _ in range(k):
            self.pos, self.prev, self.vel, self.quats = \
                self.mod.jacobi_frame(self.pos, self.vel, self.quats,
                                      self.arrays, params, self.gid,
                                      self.gpos)


class _World:
    """One polar body of a large mesh, from rest, in a version's ``World``
    and stepped by ``World.step``: the path a user runs, ``Body.step``'s
    glue around ``polar_jacobi.jacobi_frame``."""

    def __init__(self, pkg, mesh, params):
        self.world = pkg.World(params=params)
        self.body = self.world.add_body(mesh, engine="polar")
        self.arrays = self.body.arrays

    @property
    def pos(self):
        return self.body.state.pos

    def step(self, params, k):
        del params  # the world's own
        self.world.step(k)


class _K9:
    """A version's extract_rotation micro-kernel as ``measure`` drives a
    batch: a step of k frames is one launch of k passes on the 1,048,576
    lanes of ``random_planes``."""

    def __init__(self, mod):
        self.mod, self.a, self.pos = mod, mod.random_planes(), None
        self.lanes = self.a[0].numel()

    def step(self, params, k):
        del params
        self.pos = self.mod.extract_rotation(self.a, k)


class _Slabs:
    """A version's slab stepper (``make``: make_nh_sharded_stepper or
    make_grid_sharded_stepper) on SlabMesh(d), as ``measure`` drives a
    batch; from rest, or with ``seed`` from velocities seeded in +-0.1 (as
    chip_smoke.py's slab_start), with no grab."""

    def __init__(self, tt, pkg, make, arrays, mesh, d, params, seed=None):
        slab_mesh = importlib.import_module(f"{pkg}.parallel").SlabMesh(d)
        prepare, self._step, _ = make(slab_mesh, arrays)
        self.arrays = arrays
        st = tt.init_state(mesh, "cuda")
        if seed is not None:
            rng = np.random.RandomState(seed)
            st = st.replace(vel=torch.tensor(
                rng.uniform(-0.1, 0.1, st.vel.shape).astype(np.float32),
                device="cuda"))
        self.packed = prepare(st, params)
        self.controls = tt.Controls.none("cuda")

    @property
    def pos(self):
        p = self.packed
        return (p.pos if hasattr(p, "pos") else p[0])[0]

    def step(self, params, k):
        for _ in range(k):
            self.packed = self._step(self.packed, params, self.controls)


def dense_mesh(tt, which):
    """The dragon, or one of chip_smoke.py phase 27's two bodies past one
    block's shared memory, the kernel's global form: (``which`` "19k")
    replicate_mesh(single_tet_mesh(), 4843), 19,372 particles, L = 1, C =
    4,864; ("19k L=6") replicate_mesh(grid_mesh(1, 1, 1, cell=0.1), 2422),
    19,376 particles, L = 6, C = 2,432; otherwise (None, "global",
    "ordered global": the dragon forced onto the global form) the
    dragon."""
    if which == "19k":
        from tetsim_torch.mesh import single_tet_mesh
        return tt.replicate_mesh(single_tet_mesh(), 4843, jitter=1.0, seed=3)
    if which == "19k L=6":
        return tt.replicate_mesh(tt.grid_mesh(1, 1, 1, cell=0.1), 2422,
                                 jitter=1.0, seed=4)
    return tt.load_dragon()


def dense_coloring(which) -> str:
    """The colouring of ``dense_mesh(which)``'s levels: the greedy one but
    for the dragon's "ordered global"."""
    return "ordered" if which == "ordered global" else "greedy"


class _Dense:
    """B dense bodies of one mesh, jittered 0.5 as chip_smoke.py's phase 27,
    stepped by a version's ``solvers.dense.step_frame`` (``form`` given:
    by its ``kernels.dense_frame.dense_frame`` forced onto that form), body
    5 (of a batch that has one) holding particle 7 5 cm up."""

    def __init__(self, mod, arrays, mesh, b, form=None):
        self.mod, self.arrays, self.form = mod, arrays, form
        self.kernel = importlib.import_module(
            mod.__name__.rsplit(".", 2)[0] + ".kernels.dense_frame")
        s = mod.init_dense_state(mesh, b, jitter=0.5, device="cuda")
        self.pos, self.prev_pos, self.vel = s.pos, s.prev_pos, s.vel
        self.gid = torch.full((b,), -1, dtype=torch.int32, device="cuda")
        self.gpos = torch.zeros((3, b), device="cuda")
        if b > 5:
            self.gid[5] = 7
            self.gpos[:, 5] = self.pos[7, :, 5] + torch.tensor(
                [0.0, 0.05, 0.0], device="cuda")

    def step(self, params, k):
        for _ in range(k):
            if self.form:
                self.pos, self.prev_pos, self.vel = self.kernel.dense_frame(
                    self.pos, self.vel, self.arrays, params, self.gid,
                    self.gpos, form=self.form)
                continue
            s = self.mod.step_frame(
                self.mod.DenseState(self.pos, self.prev_pos, self.vel),
                self.arrays, params, self.gid, self.gpos)
            self.pos, self.prev_pos, self.vel = s.pos, s.prev_pos, s.vel


def same_bits(a, b) -> bool:
    """torch.equal with NaN equal to NaN: equal NaN masks, and every other
    value bitwise (+0 and -0 equal)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


def load_version(root: str, name: str):
    """The package ``root/tetsim_torch`` imported as ``name``."""
    pkg = os.path.join(os.path.abspath(root), "tetsim_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def resource_usage(lib, kernel: str) -> dict:
    """Registers, shared and local (spill) bytes per thread of each function
    whose name holds ``kernel`` in the library ``lib`` (cuobjdump
    -res-usage beside nvcc)."""
    from tetsim_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", lib._name], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name and "REG:" in line:
            out[name] = {k: int(v) for k, v in re.findall(
                r"(REG|SHARED|LOCAL|STACK):(\d+)", line)}
            name = None
    return out


def resident_threads(regs: int, threads: int, smem: int = 0) -> int:
    """Threads an H100 SM holds of a kernel with ``regs`` registers per
    thread, ``threads`` per block and ``smem`` bytes of shared memory per
    block: 64 warps, 32 blocks, 65,536 registers allocated 256 per warp,
    233,472 bytes of shared memory less 1,024 reserved per block."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 64 // warps, 65536 // per_warp // warps,
                 233472 // (smem + 1024))
    return blocks * threads


def launch_threads(lib) -> dict:
    """Threads per block of each polar tet-pass kernel of ``lib`` (the
    first designs' fixed sizes where the library names none)."""
    if hasattr(lib, "polar_stencil_strip"):
        return {"polar_grid_tet": 6 * lib.polar_stencil_strip(),
                "polar_slab_vertex": 256,
                "polar_grid_vertex": 256, "polar_grid_acc": 256,
                "polar_grid_apply": 256}
    if hasattr(lib, "polar_pieces_threads"):
        return {"polar_pieces_kernel": lib.polar_pieces_threads()}
    if hasattr(lib, "nh_pieces_slots"):
        return {"nh_pieces": lib.nh_pieces_slots()}
    if hasattr(lib, "polar_jacobi_threads"):
        return {"polar_jacobi": lib.polar_jacobi_threads()}
    if hasattr(lib, "extract_rotation_threads"):
        return {"extract_rotation": lib.extract_rotation_threads()}
    return {"polar_grid_tet": 128, "polar_grid_vertex": 256,
            "polar_grid_acc": 256, "polar_pieces_tet": 128,
            "polar_pieces_lane": 256, "polar_jacobi_tet": 128,
            "polar_jacobi_particle": 256}


def print_usage(label: str, lib, kernel: str, smem=None) -> None:
    """``resource_usage`` of ``lib`` with the resident threads per SM that
    follow; ``smem`` (bytes per block of dynamic shared memory) where the
    launch adds some."""
    sizes = launch_threads(lib)
    for name, use in resource_usage(lib, kernel).items():
        threads = next((t for k, t in sizes.items() if k in name), None)
        if threads:
            use["threads_per_block"] = threads
            use["resident_threads_per_sm"] = resident_threads(
                use["REG"], threads, use.get("SHARED", 0) + (smem or 0))
        print(f"{label}: {name} {json.dumps(use)}", flush=True)


def dense_sass(packages) -> None:
    """Each side's dense_frame kernels' resource usage (registers, shared
    and local bytes; the cluster walk, ``dense_frame_kernel<true, true>``,
    is one build for every cluster size, a launch parameter), and whether
    B's shared form (``dense_frame_kernel<false>``, or the one kernel of a
    version before the global form) and B's global form on one block
    (``dense_frame_kernel<true>``) and B's cluster walk have A's SASS,
    instruction for instruction (addresses aside)."""
    def listing(lib, *names):
        """The SASS of the first of ``names`` that ``lib`` holds."""
        for name in names:
            out = sass_listing(lib, name)
            if out:
                return [ins[1:] for ins in out]
        return []

    forms = {"shared form": ("dense_frame_kernelILb0ELb0E",
                             "dense_frame_kernelILb0E", "dense_frame_kernel"),
             "global form on one block": ("dense_frame_kernelILb1ELb0E",
                                          "dense_frame_kernelILb1E"),
             "cluster walk": ("dense_frame_kernelILb1ELb1E",)}
    listings = {}
    for side, pkg in packages.items():
        lib = importlib.import_module(
            f"{pkg.__name__}.kernels.dense_frame").library()
        print_usage(f"[{side}] kernels.dense_frame", lib, "dense_frame_kernel")
        listings[side] = {form: listing(lib, *names)
                          for form, names in forms.items()}
    for form in forms:
        a, b = listings["A"][form], listings["B"][form]
        print(f"dense_frame: B's {form} {len(b)} SASS instructions, A's "
              f"{len(a) if a else 'none'}, the same {a == b}", flush=True)


def versions_ab(tt, parent_root: str, only=None, pairs: int = 1) -> None:
    """The dragon frame kernels, K7, K3, K4, K6, gs_levels, K3s, K4a, K5,
    polar_jacobi and K9 of an earlier version (A) and of this one (B), A B
    B A ``pairs`` times per shape (those named in ``only``, if given), then
    their bits after 3 frames (K9: 4 passes)."""
    from chip_smoke import BLOB, PIECES_TPP, event_ms

    packages = {"A": load_version(parent_root, "parent_tetsim_torch"),
                "B": tt}
    kernels = {side: {k: importlib.import_module(f"{pkg.__name__}.{m}")
                      for k, (m, _) in AB_KERNELS.items()}
               for side, pkg in packages.items()}
    shapes = [s for s in AB_SHAPES if not only or s[0] in only]
    dragon = tt.load_dragon()
    grid_mesh = tt.grid_mesh(*GRID_DIMS, **GRID_BOX)
    blob = (tt.ellipsoid_mesh(**BLOB)
            if any(s[1] in ("pieces", "piecesnh") for s in shapes) else None)
    grids = {}  # each side's arrays of the 56^3 box, of either engine
    pieces = {}  # each side's arrays of the 987k blob
    large = {}  # each side's mesh and arrays of grid_mesh(20, 20, 20)
    slab_mesh = tt.grid_mesh(*GRID_DIMS, **SLAB_BOX)

    def params_of(kind):
        if kind == "polar":
            return tt.default_gpu_params()
        if kind in ("grid", "gridpolar", "pieces", "slab", "slabpolar",
                    "piecesnh", "worldpolar", "gridbatch"):
            return tt.PhysicsParams(num_substeps=5)
        return tt.default_cpu_params()

    def dense_arrays(side, which):
        if (side, "dense", which) not in large:
            mesh = dense_mesh(tt, which)
            large[side, "dense", which] = mesh, kernels[side][
                "dense"].build_dense_arrays(
                    mesh, coloring=dense_coloring(which),
                    max_bytes=5_000_000_000, device="cuda")
        return large[side, "dense", which]

    def body(side, kind, b, coloring):
        mod = kernels[side][kind]
        pkg = packages[side]
        if kind == "dense":  # coloring: which mesh
            mesh, arrays = dense_arrays(side, coloring)
            return _Dense(mod, arrays, mesh, b, "global" if coloring
                          and coloring.endswith("global") else None)
        if kind == "worldpolar":
            return _World(pkg, pkg.grid_mesh(*LARGE_DIMS, **LARGE_BOX),
                          params_of(kind))
        if kind in ("large", "largepolar"):
            if (side, kind) not in large:
                mesh = pkg.grid_mesh(*LARGE_DIMS, **LARGE_BOX)
                large[side, kind] = mesh, pkg.build_arrays(
                    mesh, coloring="ordered" if kind == "large" else None,
                    device="cuda")
            mesh, arrays = large[side, kind]
            return (_Levels if kind == "large" else _Jacobi)(mod, arrays,
                                                             mesh, b)
        if kind == "k9":
            return _K9(mod)
        if kind == "gridbatch":  # coloring: the boxes' dims
            if (side, kind, coloring) not in grids:
                mesh = (slab_mesh if coloring == GRID_DIMS
                        else tt.grid_mesh(*coloring, **SLAB_BOX))
                solver = importlib.import_module(
                    f"{pkg.__name__}.solvers.neohookean_grid")
                grids[side, kind, coloring] = (
                    mesh, solver.build_nh_grid_arrays(mesh, coloring,
                                                      device="cuda"))
            mesh, arrays = grids[side, kind, coloring]
            return _GridBatch(mod, arrays, mesh, b)
        if kind == "slab":
            if (side, kind) not in grids:
                solver = importlib.import_module(
                    f"{pkg.__name__}.solvers.neohookean_grid")
                grids[side, kind] = solver.build_nh_grid_arrays(
                    slab_mesh, GRID_DIMS, device="cuda")
            return _Slabs(tt, pkg.__name__, mod.make_nh_sharded_stepper,
                          grids[side, kind], slab_mesh, b, params_of(kind))
        if kind == "slabpolar":
            if (side, kind) not in grids:
                solver = importlib.import_module(
                    f"{pkg.__name__}.solvers.polar_grid")
                grids[side, kind] = solver.build_grid_arrays(
                    grid_mesh, GRID_DIMS, device="cuda")
            return _Slabs(tt, pkg.__name__, mod.make_grid_sharded_stepper,
                          grids[side, kind], grid_mesh, b, params_of(kind),
                          seed=6)
        if kind == "piecesnh":  # coloring: the banded lane layout or not
            if (side, coloring) not in pieces:
                pieces[side, coloring] = mod.build_nh_pieces_arrays(
                    blob, tets_per_piece=PIECES_TPP, boundary_prefix=coloring,
                    device="cuda")
            bd = _Packed(tt, mod.make_nh_pieces_stepper(pieces[side, coloring]),
                         tt.init_state(blob, "cuda"), params_of(kind))
            bd.arrays = pieces[side, coloring]
            return bd
        if kind == "gs":
            return mod.FusedGSBody(dragon, num_bodies=b, coloring=coloring,
                                   jitter=0.2)
        if kind == "ordered":
            return mod.OrderedGSBody(dragon, jitter=0.2)
        if kind in ("grid", "gridpolar"):  # each side's own stepper
            # (World's registry names this version's modules)
            if (side, kind) not in grids:
                nh = kind == "grid"
                solver = importlib.import_module(
                    f"{packages[side].__name__}.solvers."
                    f"{'neohookean_grid' if nh else 'polar_grid'}")
                build_arrays = (solver.build_nh_grid_arrays if nh
                                else solver.build_grid_arrays)
                grids[side, kind] = build_arrays(grid_mesh, GRID_DIMS,
                                                 device="cuda")
            arrays = grids[side, kind]
            bd = _Packed(tt, mod.make_frame_stepper(arrays),
                         tt.init_state(grid_mesh, "cuda"), params_of(kind))
            bd.arrays = arrays
            return bd
        if kind == "pieces":
            if side not in pieces:
                pieces[side] = mod.build_pieces_arrays(
                    blob, tets_per_piece=PIECES_TPP, boundary_prefix=True,
                    device="cuda")
            bd = _Packed(tt, mod.make_pieces_stepper(pieces[side]),
                         tt.init_state(blob, "cuda"), params_of(kind))
            bd.arrays = pieces[side]
            return bd
        return mod.FusedPolarBody(dragon, num_bodies=b, jitter=0.2)

    def work(mod, kind, bd, params, b, coloring):
        if kind == "dense":  # this version's counts (the parent's arrays
            from tetsim_torch.kernels import dense_frame  # have no ids)
            arr = dense_arrays("B", coloring)[1]
            return (dense_frame.frame_flops(arr, params, b),
                    dense_frame.frame_bytes(arr, b))
        if kind == "gs":
            return (mod.frame_flops(bd.arrays, params, b),
                    mod.frame_bytes(bd.arrays, params, b, 1))
        if kind == "ordered":
            return (mod.frame_flops(bd.sched, params, b),
                    mod.frame_bytes(bd.sched, b, 1))
        if kind in ("grid", "slab"):
            return (mod.frame_flops(bd.arrays, params, 1),
                    mod.frame_bytes(bd.arrays, params, 1, 1))
        if kind == "gridbatch":
            return (mod.frame_flops(bd.arrays, params, b),
                    mod.frame_bytes(bd.arrays, params, b, 1))
        if kind == "large":
            return (mod.frame_flops(bd.arrays, params, b),
                    mod.frame_bytes(bd.arrays, params, b, 1))
        if kind == "k9":  # one pass: the planes read, the quaternions written
            return mod.extract_rotation_flops(bd.lanes), (9 + 4) * 4 * bd.lanes
        if kind == "gridpolar":
            return (mod.frame_flops(bd.arrays, params, 1),
                    mod.frame_bytes(bd.arrays, 1, 1))
        if kind in ("pieces", "piecesnh"):
            return (mod.frame_flops(bd.arrays, params),
                    mod.frame_bytes(bd.arrays, params))
        if kind == "slabpolar":  # the unsharded box's work
            return (mod.frame_flops(bd.arrays, params, 1),
                    mod.frame_bytes(bd.arrays, 1, 1))
        return (mod.frame_flops(bd.arrays, params, b),
                mod.frame_bytes(bd.arrays, b, 1))

    def state(kind, bd):
        if kind in ("grid", "gridpolar", "pieces", "piecesnh"):
            return list(bd.packed)
        if kind == "slab":
            return list(bd.packed[0]) + list(bd.packed[1])
        if kind == "slabpolar":
            p = bd.packed
            return [*p.pos, *p.prev, *p.vel, *p.quats]
        if kind in ("large", "gridbatch"):
            return [bd.pos, bd.prev, bd.vel, bd.vol_err]
        if kind == "largepolar":
            return [bd.pos, bd.prev, bd.vel, bd.quats]
        if kind == "worldpolar":
            s = bd.body.state
            return [s.pos, s.prev_pos, s.vel, s.quats]
        if kind == "k9":
            return [bd.pos]
        return [bd.pos, bd.prev_pos, bd.vel] + (
            [bd.last_diag] if kind == "gs" else
            [bd.quats] if kind == "polar" else [])

    def solve_ms(side, bd):
        """The pieces solve alone by CUDA events on the packed state's
        predicted planes (50 calls after one)."""
        mod, arr = kernels[side]["pieces"], bd.arrays
        params = params_of("pieces")
        planes = mod.predict_planes(*bd.packed[:6], arr.movw_l > 0.0,
                                    params.dt, params)[:3]
        return event_ms(lambda: mod.pieces_solve(*planes, bd.packed[6], arr),
                        50)

    for side in packages:
        for kind in ("gridpolar", "pieces", "slabpolar", "piecesnh",
                     "largepolar", "k9"):
            if any(s[1] == kind for s in shapes):
                mod = kernels[side][kind]
                smem = getattr(mod, "smem_bytes", None)  # a one-block design
                lanes = PIECES_LANES[:1] if kind == "piecesnh" else PIECES_LANES
                print_usage(f"[{side}] {AB_KERNELS[kind][0]}", mod.library(),
                            AB_KERNELS[kind][1],
                            smem(*lanes) if smem else None)
                if hasattr(mod, "frame_grid") and kind == "largepolar":
                    dev = torch.device("cuda", 0)
                    print(f"[{side}] {AB_KERNELS[kind][0]}: (blocks per SM, "
                          f"SMs) {mod.occupancy(dev)}, cooperative grid "
                          f"{mod.frame_grid(dev)} blocks", flush=True)
    if any(s[1] == "dense" for s in shapes):
        dense_sass(packages)
    pending = []
    for name, kind, b, coloring, k1, k2 in shapes:
        mod = kernels["B"][kind]
        params = params_of(kind)
        for side in "ABBA" * pairs:
            bd = body(side, kind, b, coloring)
            pos_sum = ((lambda bd=bd: bd.packed[0].sum())
                       if hasattr(bd, "packed")
                       and kind not in ("slab", "slabpolar") else None)
            row, profile = measure(
                bd, params, k1, k2, AB_KERNELS[kind][1],
                *work(mod, kind, bd, params, b, coloring), state_sum=pos_sum)
            if kind in ("gridpolar", "slab", "slabpolar", "piecesnh",
                        "gridbatch"):
                row["ms_per_substep"] = row["event_ms"] / params.num_substeps
            if kind == "pieces":
                row["solve_event_ms"] = solve_ms(side, bd)
            pending.append((f"{name} [{side}]", profile))
    for name, profile in pending:
        print(name, json.dumps(profile()), flush=True)
    for name, kind, b, coloring, _, _ in shapes:
        params = params_of(kind)
        frames = 4 if kind == "k9" else 3  # K9: one launch of 4 passes
        out = {}
        for side in "AB":
            bd = body(side, kind, b, coloring)
            bd.step(params, frames)
            out[side] = state(kind, bd)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(out["A"], out["B"]))
        worst = max(max_diff(x, y) for x, y in zip(out["A"], out["B"]))
        print(f"{name}: A vs B after {frames} "
              f"{'passes' if kind == 'k9' else 'frames'}, bitwise {same} "
              f"(largest difference {worst:.3e})", flush=True)
        if kind == "dense":  # a NaN and an inf planted in particle 11 of
            for plant in (float("nan"), float("inf")):  # bodies 0 and 1
                for side in "AB":
                    bd = body(side, kind, b, coloring)
                    bd.pos = bd.pos.clone()
                    bd.pos[11, 1, :2] = plant
                    bd.step(params, frames)
                    out[side] = state(kind, bd)
                same = all(same_bits(x, y)
                           for x, y in zip(out["A"], out["B"]))
                print(f"{name} with {plant} planted in bodies 0 and 1: A vs "
                      f"B after {frames} frames, bitwise with equal NaN "
                      f"masks {same}", flush=True)


def variants(tt) -> None:
    """K4 at strips of 32 and 64 cubes per pass-A block on the packed 56^3
    box, and K6 at 256, 384 and 512 threads per block on the packed 987k
    blob (its solve alone by CUDA events), each build's resource usage and
    times in the columns above, the builds in the order A B B A (A B C C B
    A)."""
    from chip_smoke import BLOB, PIECES_TPP, event_ms
    from tetsim_torch.kernels import polar_pieces, polar_stencil
    from tetsim_torch.solvers import polar_grid

    params = tt.PhysicsParams(num_substeps=5)
    grid_mesh = tt.grid_mesh(*GRID_DIMS, **GRID_BOX)
    garr = polar_grid.build_grid_arrays(grid_mesh, GRID_DIMS, device="cuda")
    blob = tt.ellipsoid_mesh(**BLOB)
    parr = polar_pieces.build_pieces_arrays(
        blob, tets_per_piece=PIECES_TPP, boundary_prefix=True, device="cuda")
    cases = (
        (polar_stencil, STRIPS, "polar_grid_", 20, 120,
         lambda: _Packed(tt, polar_stencil.make_frame_stepper(garr),
                         tt.init_state(grid_mesh, "cuda"), params),
         (polar_stencil.frame_flops(garr, params, 1),
          polar_stencil.frame_bytes(garr, 1, 1)), None),
        (polar_pieces, PIECES_THREADS, "polar_pieces_", 4, 24,
         lambda: _Packed(tt, polar_pieces.make_pieces_stepper(parr),
                         tt.init_state(blob, "cuda"), params),
         (polar_pieces.frame_flops(parr, params),
          polar_pieces.frame_bytes(parr, params)),
         polar_pieces.smem_bytes(parr.rp, parr.rt)))
    pending = []
    for mod, builds, kernel, k1, k2, make, work, smem in cases:
        for flags in builds:
            with flags_build(mod, flags) as lib:
                print_usage(f"{mod.__name__.split('.')[-1]} "
                            f"[{build_name(flags)}]", lib, kernel, smem)
        for flags in (*builds, *builds[::-1]):
            def build(flags=flags):
                return flags_build(mod, flags)

            with build():
                bd = make()
                row, profile = measure(
                    bd, params, k1, k2, kernel, *work,
                    state_sum=lambda bd=bd: bd.packed[0].sum(), build=build)
                row["ms_per_substep"] = row["event_ms"] / params.num_substeps
                if mod is polar_pieces:
                    planes = polar_pieces.predict_planes(
                        *bd.packed[:6], parr.movw_l > 0.0, params.dt,
                        params)[:3]
                    row["solve_event_ms"] = event_ms(
                        lambda: polar_pieces.pieces_solve(
                            *planes, bd.packed[6], parr), 50)
            pending.append((f"{mod.__name__.split('.')[-1]} "
                            f"[{build_name(flags)}]", profile))
    for name, profile in pending:
        print(name, json.dumps(profile()), flush=True)


PHASES = ("predict", "phase A", "barrier 1", "phase B", "barrier 2")


def polar_phases(tt) -> None:
    """SM cycles per substep of each phase of polar_frame on block 0."""
    import ctypes

    from tetsim_torch.kernels import polar_fused

    dragon = tt.load_dragon()
    params = tt.default_gpu_params()
    with flags_build(polar_fused, ("-DPOLAR_FRAME_PHASES",)) as lib:
        lib.polar_frame_phase_cycles.argtypes = [ctypes.c_void_p]
        waves = polar_fused.active_clusters(torch.device("cuda", 0),
                                            dragon.num_particles)
        cases = [(1, cs) for cs, n in waves.items() if n >= 1] + [
            (b, polar_fused.cluster_size(b, polar_fused.MAX_CLUSTER, waves))
            for b in (8, 132)]
        cycles = (ctypes.c_ulonglong * 6)()
        for b, cs in cases:
            body = polar_fused.FusedPolarBody(dragon, b)
            state = [body.pos, body.vel, body.quats]

            def step(k):
                for _ in range(k):
                    p, _, v, q = polar_fused._polar_frame_cuda(
                        *state, body.arrays, params, body.grab_id,
                        body.grab_pos, cs=cs)
                    state[:] = p, v, q
                torch.cuda.synchronize()

            step(3)
            lib.polar_frame_phase_cycles(cycles)
            step(20)
            if lib.polar_frame_phase_cycles(cycles):
                raise RuntimeError("polar_frame_phase_cycles failed")
            per = [cycles[k] / cycles[5] for k in range(5)]
            print(f"polar_frame B={b} cs={cs}: SM cycles per substep on block "
                  "0: " + ", ".join(f"{n} {c:.0f}" for n, c in zip(PHASES, per))
                  + f"; total {sum(per):.0f}", flush=True)


def sass_listing(lib, kernel: str) -> list:
    """(address, predicate, opcode, operands) of each SASS instruction of
    the function whose name holds ``kernel`` in ``lib`` (cuobjdump -sass
    beside nvcc)."""
    from tetsim_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9._]*)\s*([^;]*);", line)
            if m:
                out.append((int(m.group(1), 16), m.group(2) or "",
                            m.group(3), m.group(4)))
    return out


SASS_OPS = ("FFMA", "FMUL", "FADD", "MUFU", "SHFL", "LDS", "STS", "LDG")


def sass_counts(lib, kernel: str) -> dict:
    """SASS instructions of the function whose name holds ``kernel`` in the
    library ``lib`` (``sass_listing``): the total and a few opcodes."""
    ops = [op.split(".")[0] for _, _, op, _ in sass_listing(lib, kernel)]
    out = {"total": len(ops)}
    out.update({op: ops.count(op) for op in SASS_OPS})
    return out


def ordered_phases(tt, parent=None) -> None:
    """K7's level walk: SM cycles per sub-level on block 0 (an instrumented
    build, 8 dragons, 20 frames after 3), and the SASS instructions of the
    shipped kernel, of one tet's solve, and of the earlier version's kernel
    (``parent``)."""
    import ctypes

    from tetsim_torch.kernels import gs_ordered as go

    dragon = tt.load_dragon()
    params = tt.default_cpu_params()
    levels = go.build_ordered_schedule(dragon).num_levels
    print("gs_ordered: SASS of gs_ordered_kernel "
          f"{sass_counts(go.library(), 'gs_ordered_kernel')}", flush=True)
    with flags_build(go, ("-DGS_ORDERED_PHASES",)) as lib:
        print("gs_ordered: SASS of one solve "
              f"{sass_counts(lib, 'gs_ordered_solve_probe')}", flush=True)
        lib.gs_ordered_phase_cycles.argtypes = [ctypes.c_void_p]
        cycles = (ctypes.c_ulonglong * 2)()
        body = go.OrderedGSBody(dragon)
        body.step(params, 3)
        torch.cuda.synchronize()
        lib.gs_ordered_phase_cycles(cycles)
        body.step(params, 20)
        torch.cuda.synchronize()
        if lib.gs_ordered_phase_cycles(cycles):
            raise RuntimeError("gs_ordered_phase_cycles failed")
        walk = cycles[0] / cycles[1]
        print(f"gs_ordered B=8: SM cycles per substep's walk on block 0 "
              f"{walk:.0f}: {walk / levels:.1f} per sub-level ({levels})",
              flush=True)
    if parent is not None:
        plib = importlib.import_module(
            "parent_tetsim_torch.kernels.gs_ordered").library()
        print("gs_ordered earlier version: SASS of gs_ordered_kernel "
              f"{sass_counts(plib, 'gs_ordered_kernel')}", flush=True)


def grid_phases(tt) -> None:
    """K3 on the packed 56^3 box at 1 and 2 blocks per SM: SM cycles on
    block 0 per substep of its particle phases, per colour phase and per
    grid barrier, and its neighbour waits between colours: how many, how
    many found a flag not yet ready at the first poll, the SM cycles each
    (an instrumented build, 20 frames after 3); and the us of one grid
    barrier alone (1,000 barriers in one launch, CUDA events)."""
    import ctypes

    from tetsim_torch.kernels import nh_stencil as nh
    from chip_smoke import grid_box, no_grab

    params = tt.PhysicsParams(num_substeps=5)
    arr, pos, vel, _ = grid_box(tt, False, GRID_DIMS, **GRID_BOX)
    gid, gpos = no_grab(1)
    dev = pos.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with flags_build(nh, ("-DNH_STENCIL_PHASES",)) as lib:
        lib.nh_stencil_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.nh_stencil_sync_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
        per_sm, sms = nh.occupancy(dev)
        struct = nh._frame_params(arr, params)
        for bps in (1, 2):
            # nh_stencil.frame_grid's one block per SM, or two: the launch
            # of nh_stencil._grid_frame_cuda on a grid of this size
            grid = min(bps, per_sm) * sms
            lanes = nh.item_lanes(arr.dims, 1, grid, False)
            reach = nh.reach(arr.dims, lanes)
            flags = torch.empty(nh.partial_blocks(arr.dims, lanes)
                                * nh.FLAG_INTS, dtype=torch.int32, device=dev)
            state = [pos, vel]

            def step(k, grid=grid, lanes=lanes, reach=reach, flags=flags):
                for _ in range(k):
                    out = [torch.empty_like(pos) for _ in range(3)]
                    err = lib.nh_stencil_launch(
                        *(x.data_ptr() for x in state + out), None, None,
                        flags.data_ptr(), arr.inv_mass.data_ptr(),
                        gid.data_ptr(), gpos.data_ptr(), 1, gid.shape[-1],
                        params.num_substeps, lanes, reach, grid, struct,
                        stream)
                    if err:
                        raise RuntimeError(
                            "nh_stencil launch failed: "
                            f"{lib.nh_stencil_error_string(err).decode()}")
                    state[:] = out[0], out[2]
                torch.cuda.synchronize()

            cycles = (ctypes.c_ulonglong * 7)()
            step(3)
            lib.nh_stencil_phase_cycles(cycles)
            step(20)
            if lib.nh_stencil_phase_cycles(cycles):
                raise RuntimeError("nh_stencil_phase_cycles failed")
            per = [cycles[k] / cycles[3] for k in range(3)]
            waits, late, wait_cycles = cycles[4], cycles[5], cycles[6]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            for iters in (10, 1010):
                start.record()
                if lib.nh_stencil_sync_probe(grid, iters, stream):
                    raise RuntimeError("nh_stencil_sync_probe failed")
                end.record()
                end.synchronize()
                if iters == 10:
                    t10 = start.elapsed_time(end)
            probe_us = (start.elapsed_time(end) - t10) * 1e3 / 1000
            print(f"nh_stencil {bps} block(s) per SM ({grid} "
                  "blocks), 56^3: SM cycles per substep on block 0: "
                  f"particle phases {per[0]:.0f}, colour phases "
                  f"{per[1]:.0f} ({per[1] / nh.COLORS:.0f} per colour, "
                  "their waits included), grid barriers "
                  f"{per[2]:.0f} ({per[2] / 2:.0f} per barrier, 2 a "
                  f"substep); neighbour waits {waits / cycles[3]:.1f} per "
                  f"substep (items of {lanes} lanes, reach {reach}), "
                  f"{100 * late / max(waits, 1):.1f}% of them not ready "
                  f"at the first poll, {wait_cycles / max(waits, 1):.0f} "
                  f"SM cycles each ({wait_cycles / cycles[3]:.0f} per "
                  f"substep); one grid barrier alone {probe_us:.3f} us",
                  flush=True)


def levels_phases(tt) -> None:
    """gs_levels on grid_mesh(20, 20, 20): SM cycles on block 0 of the
    launch per substep of its particle phases, per level phase and per
    cluster barrier (an instrumented build, 20 frames after 3), one body at
    every cluster size the card runs and 8 bodies at the size they take,
    and the us of one cluster barrier alone at that launch shape (1,000 in
    one launch, CUDA events)."""
    import ctypes

    from tetsim_torch.kernels import gs_levels

    mesh = tt.grid_mesh(*LARGE_DIMS, **LARGE_BOX)
    params = tt.default_cpu_params()
    with flags_build(gs_levels, ("-DGS_LEVELS_PHASES",)) as lib:
        lib.gs_levels_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.gs_levels_sync_probe.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        arr = tt.build_arrays(mesh, coloring="ordered", device="cuda")
        dev = arr.inv_mass.device
        waves = gs_levels.active_clusters(dev)
        cases = [(1, cs) for cs, n in waves.items() if n >= 1] + [
            (8, gs_levels.cluster_size(8, gs_levels.MAX_CLUSTER, waves))]
        cycles = (ctypes.c_ulonglong * 5)()
        for b, cs in cases:
            bd = _Levels(gs_levels, arr, mesh, b)

            def step(k):
                for _ in range(k):
                    out = gs_levels._levels_frame_cuda(
                        bd.pos, bd.vel, arr, params, bd.gid, bd.gpos, cs=cs)
                    bd.pos, bd.vel = out[0], out[2]
                torch.cuda.synchronize()

            step(3)
            lib.gs_levels_phase_cycles(cycles)
            step(20)
            if lib.gs_levels_phase_cycles(cycles):
                raise RuntimeError("gs_levels_phase_cycles failed")
            substeps, levels = cycles[3], cycles[4]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            stream = torch.cuda.current_stream(dev).cuda_stream
            for iters in (10, 1010):
                start.record()
                if lib.gs_levels_sync_probe(b, cs, iters, stream):
                    raise RuntimeError("gs_levels_sync_probe failed")
                end.record()
                end.synchronize()
                if iters == 10:
                    t10 = start.elapsed_time(end)
            probe_us = (start.elapsed_time(end) - t10) * 1e3 / 1000
            print(f"gs_levels B={b} cs={cs} {LARGE_DIMS}: SM cycles on block "
                  f"0 per substep: particle phases "
                  f"{cycles[0] / substeps:.0f}, levels "
                  f"{cycles[1] / substeps:.0f} ({cycles[1] / levels:.0f} per "
                  f"level, {levels // substeps} levels), barriers "
                  f"{cycles[2] / substeps:.0f} "
                  f"({cycles[2] / (levels + substeps):.0f} per barrier); one "
                  f"cluster barrier alone {probe_us:.3f} us", flush=True)


def jacobi_phases(tt) -> None:
    """polar_jacobi on grid_mesh(20, 20, 20) at B = 1 and 8 (the _Jacobi
    bodies of --parent): SM cycles on block 0 of the launch per substep of
    its tet pass and its particle pass, per frame of its predict phase, and
    per grid barrier (an instrumented build, 20 frames after 3), and the us
    of one grid barrier alone at the frame's grid (1,000 in one launch, CUDA
    events)."""
    import ctypes

    from tetsim_torch.kernels import polar_jacobi as pj

    mesh = tt.grid_mesh(*LARGE_DIMS, **LARGE_BOX)
    params = tt.default_cpu_params()
    with flags_build(pj, ("-DPOLAR_JACOBI_PHASES",)) as lib:
        lib.polar_jacobi_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.polar_jacobi_sync_probe.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        arr = tt.build_arrays(mesh, coloring=None, device="cuda")
        dev = arr.inv_mass.device
        grid = pj.frame_grid(dev)
        print(f"polar_jacobi [-DPOLAR_JACOBI_PHASES]: (blocks per SM, SMs) "
              f"{pj.occupancy(dev)}, grid {grid}", flush=True)
        print_usage("polar_jacobi [-DPOLAR_JACOBI_PHASES]", lib,
                    "polar_jacobi_frame")
        cycles = (ctypes.c_ulonglong * 5)()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b in (1, 8):
            bd = _Jacobi(pj, arr, mesh, b)
            bd.step(params, 3)
            torch.cuda.synchronize()
            lib.polar_jacobi_phase_cycles(cycles)
            bd.step(params, 20)
            torch.cuda.synchronize()
            if lib.polar_jacobi_phase_cycles(cycles):
                raise RuntimeError("polar_jacobi_phase_cycles failed")
            substeps = cycles[4]
            frames = substeps / params.num_substeps
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            for iters in (10, 1010):
                start.record()
                if lib.polar_jacobi_sync_probe(grid, iters, stream):
                    raise RuntimeError("polar_jacobi_sync_probe failed")
                end.record()
                end.synchronize()
                if iters == 10:
                    t10 = start.elapsed_time(end)
            probe_us = (start.elapsed_time(end) - t10) * 1e3 / 1000
            print(f"polar_jacobi B={b} {LARGE_DIMS}: SM cycles on block 0: "
                  f"predict {cycles[0] / frames:.0f} per frame, tet pass "
                  f"{cycles[1] / substeps:.0f} and particle pass "
                  f"{cycles[2] / substeps:.0f} per substep, barriers "
                  f"{cycles[3] / (2 * substeps):.0f} per barrier (2 per "
                  f"substep); one grid barrier alone {probe_us:.3f} us",
                  flush=True)


def block_spread(lib, blocks: int) -> str:
    """The last launch's blocks as an instrumented dense_frame build
    recorded them (``dense_frame_block_ns``: each block's start and end on
    the globaltimer): how far apart they start, how long each runs
    (least, median, most) and the launch's span, in us."""
    import ctypes

    marks = (ctypes.c_ulonglong * (2 * 4096))()
    if lib.dense_frame_block_ns(marks):
        raise RuntimeError("dense_frame_block_ns failed")
    n = min(blocks, 4096)
    start = np.array(marks[:n], dtype=np.int64)
    end = np.array(marks[4096:4096 + n], dtype=np.int64)
    run = np.sort(end - start) / 1e3
    return (f"blocks start within {(start.max() - start.min()) / 1e3:.1f} us, "
            f"run {run[0]:.1f} / {run[n // 2]:.1f} / {run[-1]:.1f} us "
            f"(least / median / most), span "
            f"{(end.max() - start.min()) / 1e3:.1f} us")


def dense_phases(tt) -> None:
    """dense_frame's cluster walk: SM cycles on block 0 of the launch per
    substep of its particle passes, per level of its level walk and per
    barrier (an instrumented build, ``-DDENSE_FRAME_PHASES``, 20 frames
    after 3), with the instrumented frame's ms by CUDA events and its
    blocks' spread (``block_spread``), on the two bodies past one block's
    shared memory (``dense_mesh``: "19k", L = 1, and "19k L=6") at B = 1
    and 8 at the plan's cluster, and on 8 greedy dragons forced onto the
    global form on a cluster of 2 (levels of 256 slots, where
    ``cluster_cap`` keeps one block); beside each, the same batch on one
    block a body (the shared form's walk, which has no marks: its ms a
    frame alone), and "19k" at B = 128, where the plan takes one block."""
    import ctypes

    from tetsim_torch.kernels import dense_frame
    from tetsim_torch.solvers import dense

    params = tt.default_cpu_params()
    with flags_build(dense_frame, ("-DDENSE_FRAME_PHASES",)) as lib:
        lib.dense_frame_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.dense_frame_block_ns.argtypes = [ctypes.c_void_p]
        print_usage("dense_frame [-DDENSE_FRAME_PHASES]", lib,
                    "dense_frame_kernel")
        cycles = (ctypes.c_ulonglong * 5)()
        cases = []
        for which in ("19k", "19k L=6", "dragon"):
            mesh = dense_mesh(tt, which)
            arr = dense.build_dense_arrays(mesh, max_bytes=5_000_000_000,
                                           device="cuda")
            waves = dense_frame.active_clusters(arr.irv.device)
            for b in ((8,) if which == "dragon" else (1, 8, 128)
                      if which == "19k" else (1, 8)):
                plan = dense_frame.launch_plan(
                    b, arr.num_particles, arr.slots_per_level, "global",
                    waves)
                for cs in sorted({plan.cluster, 1, 2 if which == "dragon"
                                  else 1}, reverse=True):
                    cases.append((which, mesh, arr, b, cs))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for which, mesh, arr, b, cs in cases:
            bd = _Dense(dense, arr, mesh, b)

            def run(k):
                for _ in range(k):
                    bd.pos, bd.prev_pos, bd.vel = dense_frame.dense_frame(
                        bd.pos, bd.vel, arr, params, bd.gid, bd.gpos,
                        form="global", cs=cs)

            run(3)
            torch.cuda.synchronize()
            lib.dense_frame_phase_cycles(cycles)
            start.record()
            run(20)
            end.record()
            end.synchronize()
            if lib.dense_frame_phase_cycles(cycles):
                raise RuntimeError("dense_frame_phase_cycles failed")
            substeps, levels = cycles[3], cycles[4]
            head = (f"dense_frame global {which} B={b} cs={cs} "
                    f"({arr.num_particles} particles, L = {arr.num_levels}, "
                    f"C = {arr.slots_per_level}): ")
            ms = start.elapsed_time(end) / 20
            if not substeps:  # one block: the shared form's walk, unmarked
                print(f"{head}{ms:.4f} ms a frame", flush=True)
                continue
            print(f"{head}SM cycles on block 0 per substep: particle passes "
                  f"{cycles[0] / substeps:.0f}, levels "
                  f"{cycles[1] / substeps:.0f} ({cycles[1] / levels:.0f} per "
                  f"level), barriers {cycles[2] / substeps:.0f} "
                  f"({cycles[2] / (levels + substeps):.0f} per barrier); "
                  f"{ms:.4f} ms a frame (instrumented); "
                  f"{block_spread(lib, b * cs)}", flush=True)


SLOW_OPS = ("CALL", "STL", "LDL", "LDG")  # slow-path calls and local memory


def fast_path(listing) -> list:
    """The opcodes one thread issues through straight-line code from the
    first instruction to EXIT when no slow path is taken: a conditional
    forward branch around a region that holds a slow-path call or local or
    global memory (``SLOW_OPS``) and no MUFU is taken, every other one
    falls through; a backward branch is not taken."""
    at = {ins[0]: k for k, ins in enumerate(listing)}
    ops, k = [], 0
    while k < len(listing):
        addr, pred, op, args = listing[k]
        ops.append(op)
        if op == "EXIT" and not pred:
            break
        if op.startswith("BRA"):
            target = int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16)
            if target > addr:
                skipped = [x[2] for x in listing[k + 1:at[target]]]
                if not pred or (
                        any(o.startswith(SLOW_OPS) for o in skipped)
                        and not any(o.startswith("MUFU") for o in skipped)):
                    k = at[target]
                    continue
        k += 1
    return ops


def sass_classes(ops) -> dict:
    """Counts of ``ops`` by class: the FP32 pipe's FFMA / FMUL / FADD, the
    MUFU pipe, slow-path CALLs, branches (BRA, BSSY, BSYNC), local-memory
    LDL / STL, and the total."""
    def n(*prefixes):
        return sum(op.startswith(prefixes) for op in ops)

    return {"total": len(ops), "FFMA/FMUL/FADD": n("FFMA", "FMUL", "FADD"),
            "MUFU": n("MUFU"), "CALL": n("CALL"),
            "BRA/BSSY/BSYNC": n("BRA", "BSSY", "BSYNC"),
            "LDL/STL": n("LDL", "STL")}


def sm_clock_during(run) -> str:
    """nvidia-smi's SM clock (and its maximum) read while ``run()``, an
    enqueued stretch of device work, runs."""
    run()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    torch.cuda.synchronize()
    return out.strip().splitlines()[0]


def k9_stream(tt) -> None:
    """K9's instruction stream on the 1,048,576 lanes of
    ``roofline.random_planes``: the library's resource usage, its SASS per
    iteration by class (a probe build, two iterations less one: all of the
    code, and the fast path alone), its ms per pass by CUDA events (64
    passes less 16 in one launch each, best of 3) and the issue floor of
    the fast path: its instructions per pass and lane over 4 warp
    instructions per SM and cycle (the MUFU pipe's 16 lanes per SM and
    cycle beside it) at the SM clock read while K9 runs."""
    del tt
    from tetsim_torch import roofline

    a = roofline.random_planes()
    lanes = a[0].numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print_usage("extract_rotation", roofline.library(),
                "extract_rotation_kernel")
    with flags_build(roofline, ("-DEXTRACT_ROTATION_PROBE",)) as lib:
        one, two = (sass_listing(lib, f"extract_rotation_probe{n}")
                    for n in (1, 2))
    whole = {k: v - sass_classes([x[2] for x in one])[k]
             for k, v in sass_classes([x[2] for x in two]).items()}
    fast = {k: v - sass_classes(fast_path(one))[k]
            for k, v in sass_classes(fast_path(two)).items()}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    roofline.extract_rotation(a, 4)  # warm
    best = float("inf")
    for _ in range(3):
        t = {}
        for k in (16, 64):
            start.record()
            roofline.extract_rotation(a, k)
            end.record()
            end.synchronize()
            t[k] = start.elapsed_time(end)
        best = min(best, (t[64] - t[16]) / 48)
    clock = sm_clock_during(lambda: roofline.extract_rotation(a, 10000))
    mhz = float(clock.split(",")[0].split()[0])
    cycles = roofline.EXTRACT_ITERS * lanes / sms
    issue_ms = cycles * fast["total"] / 32 / 4 / (mhz * 1e3)
    mufu_ms = cycles * fast["MUFU"] / 16 / (mhz * 1e3)
    print(f"extract_rotation: SASS per iteration, all code "
          f"{json.dumps(whole)}, fast path {json.dumps(fast)}; "
          f"{best:.5f} ms per pass; issue floor {issue_ms:.5f} ms "
          f"({fast['total']} fast-path instructions per iteration at "
          f"{mhz:.0f} MHz on {sms} SMs), MUFU floor {mufu_ms:.5f} ms; SM "
          f"clock while it runs {clock}", flush=True)


VARIANT_RUNS = (("K4 K6", variants),)
PHASE_RUNS = (("polar_frame", polar_phases), ("gs_ordered", ordered_phases),
              ("nh_stencil", grid_phases), ("gs_levels", levels_phases),
              ("polar_jacobi", jacobi_phases), ("K9", k9_stream),
              ("dense_frame", dense_phases))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an earlier version to time "
                        "against (see the module docstring)")
    parser.add_argument("--only", nargs="+", metavar="NAME",
                        help="only these shapes (names of AB_SHAPES) with "
                        "--parent, these kernels (names of PHASE_RUNS) "
                        "with --phases, these builds (names of "
                        "VARIANT_RUNS) with --variants")
    parser.add_argument("--pairs", type=int, default=1,
                        help="with --parent, A B B A this many times per "
                        "shape")
    parser.add_argument("--phases", action="store_true",
                        help="SM cycles per phase of polar_frame, "
                        "gs_ordered, nh_stencil, gs_levels, polar_jacobi, "
                        "dense_frame's global form; K9's SASS per "
                        "iteration and issue floor")
    parser.add_argument("--variants", action="store_true",
                        help="K4's strip widths and K6's block sizes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tetsim_torch as tt
    if args.parent or args.phases or args.variants:
        print(card(), flush=True)
        if args.parent:
            versions_ab(tt, args.parent, args.only, args.pairs)
        runs = ((VARIANT_RUNS if args.variants else ())
                + (PHASE_RUNS if args.phases else ()))
        for name, run in runs:
            if not args.only or name in args.only:
                if run is ordered_phases:
                    run(tt, args.parent)
                else:
                    run(tt)
        print(card(), flush=True)
        return 0
    from tetsim_torch.kernels import gs_fused, gs_ordered, polar_fused
    from tetsim_torch.kernels.gs_fused import FusedGSBody
    from tetsim_torch.kernels.polar_fused import FusedPolarBody

    print(card(), flush=True)
    dragon = tt.load_dragon()
    builds = (polar_fused.NVCC_FLAGS, UNCONTRACTED)
    for flags in builds:
        with flags_build(polar_fused, flags):
            pass
    pending = []  # (name, profile): every shape is timed before any profiling
    for name, b, coloring, k1, k2 in SHAPES:
        if coloring is None:
            params, kernel = tt.default_gpu_params(), "polar_frame_kernel"
            for flags in (*builds, *builds[::-1]):  # A B B A
                body = FusedPolarBody(dragon, num_bodies=b)
                work = (polar_fused.frame_flops(body.arrays, params, b),
                        polar_fused.frame_bytes(body.arrays, b, 1))

                def build(flags=flags):
                    return flags_build(polar_fused, flags)

                with build():
                    _, profile = measure(body, params, k1, k2, kernel, *work,
                                         build=build)
                pending.append((f"{name} [{build_name(flags)}]", profile))
        elif coloring == "exact":
            body = gs_ordered.OrderedGSBody(dragon)
            params, kernel = tt.default_cpu_params(), "gs_ordered_kernel"
            work = (gs_ordered.frame_flops(body.sched, params, b),
                    gs_ordered.frame_bytes(body.sched, b, 1))
            pending.append((name, measure(body, params, k1, k2, kernel,
                                          *work)[1]))
        else:
            body = FusedGSBody(dragon, num_bodies=b, coloring=coloring)
            params, kernel = tt.default_cpu_params(), "gs_frame_kernel"
            work = (gs_fused.frame_flops(body.arrays, params, b),
                    gs_fused.frame_bytes(body.arrays, params, b, 1))
            pending.append((name, measure(body, params, k1, k2, kernel,
                                          *work)[1]))
    grid_profile(tt, pending)
    retimes = pieces_profile(tt, pending)
    for name, profile in pending:
        print(name, json.dumps(profile()), flush=True)
    for name, retime in retimes:
        print(f"{name} after the profiler sessions: host_ms "
              f"{retime() * 1e3:.4f}", flush=True)
    polar_agreement(tt, polar_fused, dragon, builds)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
