#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tetsim_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each with its seconds; any failure raises and the exit
code is non-zero:
  1. the card (nvidia-smi name and power limit) and the kernel builds, one
     nvcc per source, all started together;
  2. the Neo-Hookean frame kernel (gs_frame) vs its plain-torch twin on the
     card, greedy schedule, 8 jittered dragons, 3 frames, and a mesh wider
     than a block;
  3. the same for one dragon Body on the ordered schedule, 1 frame; the
     kernel's two level walks (warp 0 with __syncwarp(), which walk()
     picks for the ordered schedule's 22-slot levels, and every thread
     with __syncthreads()) bit for bit alike on 8 jittered ordered dragons
     with a grab, 3 frames (positions, velocities, vol_err); and in
     contact: dragons resting on the ground after 120 frames (ordered
     B=1 1 frame, greedy B=8 3 frames) and two dragons pushed past the
     side walls of the world at friction k = 0.1, 2 frames, so the clamp,
     friction and bound clip of the kernel are held to the plain twin too;
  4. the Neo-Hookean main path through the user entry points (README quick
     start): World() -> add_body(load_dragon()) -> step -> grab ->
     surface_mesh -> diagnostics, then the same with add_body_batch(...,
     engine="neohookean", backend="fused"); the kernel's launch counter
     must rise by exactly the frames stepped, and stepping must not
     synchronise with the host;
  5. dragon substeps/s of the Neo-Hookean kernel and its plain twin, and
     the kernel's us per level;
  6. the polar frame kernel (polar_frame) vs its plain twin at 20 substeps,
     after every frame: 8 jittered dragons with 3 pinned particles and a
     grab, 3 frames; 8 dragons resting on the ground, 1 frame; two dragons
     past the walls at friction k = 0.1, 2 frames; each beside the kernel's
     own spread from positions 1 ulp apart; a bitwise repeat; in each case
     the kernel at every cluster size the card runs (1, 2, 4, 8, 16 blocks
     per body) bit for bit cs = 1 after every frame, and polar_frame bit
     for bit its own choice of size; the shared-memory refusal;
  7. the polar main path: World(default_gpu_params()) with no device ->
     add_body(dragon, engine="polar"), then add_body_batch(dragon, 8) (the
     JAX default: polar, flat) and add_body_batch(..., backend="fused"),
     each 120 frames with no host sync, a grab, 30 frames, both surface
     shadings and diagnostics; the launch counter equals the frames;
  8. polar substeps/s of the kernel and its plain twin at B = 1, 8, 132,
     with the cluster size each takes and us per substep, then us per
     substep of one dragon at every cluster size;
  9. the grid stencil kernels, polar_stencil (K4) and nh_stencil (K3), vs
     their plain twins after every frame at 5 substeps (the scale
     example's): a (4, 3, 2) and a (12, 9, 7) box with 2 pinned particles,
     a grab and seeded velocities, 3 frames; a (12, 9, 7) box resting on
     the ground after 60 frames, 1 frame; two boxes past the walls at
     friction k = 0.1, 2 frames; the 56^3 box (1,053,696 tets) at cell
     0.05 and at the scale box's cell 0.02, 1 frame; each beside the
     kernel's own spread from positions 1 ulp apart;
 10. the grid main path at 56^3: World -> add_grid_body((56, 56, 56),
     cell=0.02, origin=(-0.56, 0.5, -0.56)) for all four engine names,
     packed and not where allowed, then add_grid_body_batch of two boxes,
     each 60 frames with no host sync, a grab, 20 frames, positions and
     diagnostics; each launch counter equals frames x that kernel's own
     launches per frame (K4: 2 per substep; K3: one cooperative launch per
     frame);
 11. ms per substep at 56^3 of each grid kernel and its plain twin, and K3's
     us per phase (a substep is 48 colour phases, each item waiting on its
     neighbours' flags, and a particle phase between two grid barriers);
 12. the pieces kernels, polar_pieces (K6, one launch per substep between
     torch ops) and nh_pieces (K5, one cooperative launch per frame that
     carries the whole substep), the kernel's frames vs the plain twin's,
     after every frame at 5 substeps, with the launches per frame held:
     tests_tpu's blob at 512 tets per piece, both lane layouts, 2 pinned
     particles and a grab, 3 frames; the blob resting on the ground after
     60 frames, 1 frame; blobs past +x and past -z and the ground at
     friction k = 0.1, 2 frames; the 62,370-tet blob at cell 0.05 and
     bench.py's 987,090-tet blob at cell 0.02 (2,048 tets per piece,
     banded), 2 frames; each beside the kernel's own spread from
     positions 1 ulp apart; and, for polar_pieces, whose kernel holds a
     whole piece in one block's shared memory, the 62,370-tet blob at
     8,192 tets per piece refused by name before any launch.  The
     Neo-Hookean engine collapses the 987k blob, so its whole frames there
     are held by their spread alone, and one substep at that width from
     rest with a 10x softer deviatoric compliance (the engine's own is
     chaotic within one sweep there) is held strictly instead;
 13. the pieces main path at 987,090 tets: World -> add_body(blob with its
     boundary surface, engine="polar_pieces" / "nh_pieces") for 20 frames
     with a grab, surface_mesh and diagnostics, then the packed stepper
     for 20 frames; no host sync while stepping, each launch counter
     equal to frames x the kernel's launches per frame (K6 5, K5 1);
 14. ms per substep at 987,090 tets of each pieces engine (two-point fit),
     its kernel's CUDA-event time per substep (K6's solve, K5's frame),
     bound and plain twin;
 15. the exact-order kernel (gs_ordered, K7) vs its plain twin after every
     frame at 5 substeps: 8 jittered dragons with a pinned particle and a
     grab on body 2, 3 frames; 8 dragons resting on the ground after 120
     frames, 1 frame; two dragons past +x and -z at friction k = 0.1, 2
     frames; each beside K7's own spread from positions 1 ulp apart; and K7
     vs K1 (gs_frame) on the same ordered schedule at B = 8, 1 frame;
 16. the exact-order main path: World -> add_body_batch(load_dragon(), 8,
     engine="neohookean", backend="fused_ordered", jitter=0.5) for 150
     frames with a grab, no host sync while stepping, one launch per frame,
     finite diagnostics; then world.save -> World.load(device="cuda") and
     one more frame in each world, bitwise equal; K7's ms per frame and us
     per sub-level of its level walk;
 17. the viewer on the card: a ViewerServer over a polar dragon Body (20
     substeps, K2) and the fused_ordered batch for about 5 s: /mesh,
     /state with the frame advancing, grabs on both bodies that hold their
     targets, rotated normals, /reset, /diag, no sim error, both kernels'
     counters rising, the sim's frames per second, /shutdown;
 18. the extract_rotation micro-kernel (K9) vs its twin on 1,048,576 lanes
     at 4 passes, ms per 9-iteration pass (two-point fit over 4 and 16
     passes), the twin's ms and the measured copy rate (y = x * c, 256 MB);
 19. the large bodies: World().add_body(grid_mesh(20, 20, 20), engine=
     "neohookean" | "polar") (9,261 particles, over one block's shared
     memory) through gs_levels and polar_jacobi, 5 frames with a grab, each
     frame held to the twin (positions 2e-5, velocities 2e-3 / 2e-2,
     vol_err 1e-5, quaternions 2e-5 or twice the kernel's 1-ulp spread),
     no host sync, K1 and K2 not launched, gs_levels and polar_jacobi
     once per frame (a cluster launch, a cooperative launch); then
     gs_levels through levels_frame on 8 jittered bodies with two grabs
     and on one body at cs = 1 (a cluster of one block), 2 frames each at
     the same bars, cs = 1 bit for bit the body's own cluster size; and
     polar_jacobi through jacobi_frame on 8 jittered bodies with two
     grabs, 2 frames at the same bars;
 20. the flat Neo-Hookean batch: add_body_batch(dragon, 8, engine=
     "neohookean", backend="flat") with a grab, frame 1 within 2e-5 of the
     plain twin (velocities 2e-2, as phase 2 holds K1), 2 frames bitwise
     FusedGSBody(coloring="ordered"), one K1 launch per frame;
 21. the polar slab form (K4a): the 56^3 box at cell 0.02 through
     make_grid_sharded_stepper on SlabMesh(4), SlabMesh(2) and SlabMesh(1),
     3 frames from seeded velocities with a grab on a slab boundary, two
     launches per substep (one host call per frame), after every frame
     within 2e-5 or twice K4's 1-ulp spread of K4 unsharded and at the
     polar bars of the sharded twin;
 22. the Neo-Hookean slab form (K3s): the 56^3 box at cell 0.05 through
     make_nh_sharded_stepper on SlabMesh(4), SlabMesh(2) and SlabMesh(1),
     3 frames each, one cooperative launch per frame, bit for bit K3
     unsharded after every frame, and at 4 slabs within 2e-5 / 2e-3 of the
     sharded twin;
 23. ms per substep at 56^3 of both slab forms at 1, 2 and 4 slabs beside
     the unsharded kernels, with launches per frame and the sharded
     twins' ms; ms per frame of gs_levels and polar_jacobi on
     grid_mesh(20, 20, 20) and of their twins;
 24. the body axis (parallel.DeviceMesh of the one card repeated 2 and 4
     times, and of distinct cards where the host has several):
     FusedGSBody(dragon, 8) greedy and FusedPolarBody(dragon, 8), jittered,
     with a grab on body 5, shard()ed, bit for bit the unsharded batch
     after each of 3 frames, one launch per shard and frame, no host sync;
     make_sharded_step's body axis (both engines) bit for bit the engine's
     step_frame body by body over 3 frames; ms per frame of both batches
     at 1, 2 and 4 shards on one card;
 25. the tet axis, the dragon in 2 and 4 shards on one card from seeded
     velocities with a gentle grab: the polar engine (plain torch, the
     shards' sums added once per solve) against K2 after each of 2 frames
     and nh_shard on the greedy schedule against K1 after 1 frame, both
     within 2e-5 or twice the engine's 1-ulp spread, no fused launch, with
     nh_shard's exchange bytes per substep beside the dense exchange and
     each form's ms per frame;
 26. the rest of the public surface: the dragon through a 1-based TetGen
     .node/.ele pair and an npz round trip, equal, and 3 polar frames of
     it; examples/torch_drop_dragon.py,
     torch_cantilever.py and torch_scale_grid.py for 3 frames each, their
     kernels' launch counts held;
 27. the dense engine: World -> add_body_batch(
     load_dragon(), 128, engine="neohookean", backend="dense", jitter=0.5)
     on the greedy colouring with a grab on body 5, 3 frames with no host
     sync, each held to the plain twin (the one-hot products and the plain
     level solve) at positions 2e-5 and velocities 2e-3 or twice the kernel
     path's spread from a start 1 ulp apart; one frame-kernel launch a
     frame and the twin never called; a NaN, an inf and 1e30 planted in one
     particle of body 0, the twin's NaN masks after each frame and the
     other bodies' bits unmoved; with TF32 on, the kernel's bits unchanged
     and the twin refused; save -> World.load(device="cuda") bitwise after
     one more frame; the batch built and stepped without the one-hot (its
     peak memory below the slab's bytes); one substep of 1/300 s of 8
     dragons on the ordered colouring (703 levels, C = 128) and a frame of
     8 grid_mesh(12, 12, 12) boxes (2,197 particles, C = 512) against the
     twin, within the same bars; 8 dragons, greedy and ordered, forced
     onto the kernel's shared and global forms, bit for bit alike after
     each of 3 frames, also with a NaN planted; the two bodies past one
     block's shared memory at B = 8 on the global form,
     replicate_mesh(single_tet_mesh(), 4843) (19,372 particles, L = 1)
     through World -> add_body_batch(backend="dense") with a grab and
     replicate_mesh(grid_mesh(1, 1, 1), 2422) (19,376 particles, L = 6)
     through dense.build_dense_arrays(max_bytes=5e9) and dense.step_frame,
     each held to the twin after each of 2 frames at the same bars, one
     launch a frame, a NaN planted in body 0 (the twin's NaN masks), and
     its ms a frame by CUDA events beside its bound; ms per frame of the
     dragon at B = 8 and 128 (two-point fit and CUDA events),
     body-substeps/s, the twin's frame;
 28. the script's one torch.profiler session, last, since a session slows
     later launches on the host: diag.trace around one dense frame at B = 8,
     one at B = 128 and 3 polar World frames, each in a record_function
     range, every kernel put in the range that launched it: one
     dense_frame kernel and no gemm a dense frame, with the busy share,
     and polar_frame_kernel 3 times in the polar range (the Chrome trace
     diag.trace writes).
Then a JSON line with every kernel's numbers, the card's name and power
limit, and, last, the device line.  It exits non-zero, printing no result,
where CUDA is unavailable.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def plain(gs_fused, pos, vel, arrays, params, gid, gpos, frames):
    """``frames`` frames of the plain twin; returns (pos, vel, vol_err)."""
    for _ in range(frames):
        pos, _, vel, err = gs_fused.gs_frame_reference(
            pos, vel, arrays, params, gid, gpos)
    sync()
    return pos, vel, err


def kernel_vs_plain(tt, gs_fused, dragon, params):
    """Phases 2 and 3 before contact: returns the largest position
    difference."""
    from tetsim_torch.world import Body

    body = gs_fused.FusedGSBody(dragon, num_bodies=8, jitter=0.2)
    pos, vel = body.pos, body.vel
    body.step(params, frames=3)
    pos, vel, err = plain(gs_fused, pos, vel, body.arrays, params,
                          body.grab_id, body.grab_pos, 3)
    dp, dv = max_diff(body.pos, pos), max_diff(body.vel, vel)
    de = max_diff(body.last_diag, err)
    print(f"phase 2 greedy B=8 3 frames: kernel vs plain max|dpos| {dp:.3e} "
          f"(tol 2e-4) max|dvel| {dv:.3e} (tol 2e-2) max|dvol_err| {de:.3e} "
          "(tol 1e-5)", flush=True)
    check(dp <= 2e-4 and dv <= 2e-2 and de <= 1e-5, "phase 2 disagrees")

    # a mesh wider than the block (C > 256 slots) needing > 48 KB of shared
    # memory: 12^3 cubes, 2,197 particles, 79 KB
    box = tt.grid_mesh(12, 12, 12, cell=0.08, origin=(-0.48, 0.5, -0.48))
    wide = gs_fused.FusedGSBody(box, num_bodies=2, jitter=0.1)
    pos, vel = wide.pos, wide.vel
    wide.step(params, frames=2)
    pos, _, _ = plain(gs_fused, pos, vel, wide.arrays, params, wide.grab_id,
                      wide.grab_pos, 2)
    dw = max_diff(wide.pos, pos)
    L, C = wide.arrays.slot_valid.shape
    print(f"phase 2 wide mesh (N={box.num_particles}, L={L}, C={C}, "
          f"{gs_fused.smem_bytes(box.num_particles)} B shared) B=2 2 frames: "
          f"kernel vs plain max|dpos| {dw:.3e} (tol 2e-4)", flush=True)
    check(dw <= 2e-4, "phase 2 wide mesh disagrees")
    dp = max(dp, dw)

    one = Body(dragon)
    s0 = one.state
    one.step(params)
    rp, rv, rerr = plain(gs_fused, s0.pos[None], s0.vel[None], one.arrays,
                         params, *no_grab(1), 1)
    dp1 = max_diff(one.state.pos, rp[0])
    de1 = max_diff(one.last_diag, rerr[0])
    print(f"phase 3 ordered B=1 1 frame: kernel vs plain max|dpos| {dp1:.3e} "
          f"(tol 2e-5) max|dvel| {max_diff(one.state.vel, rv[0]):.3e} "
          f"max|dvol_err| {de1:.3e} (tol 1e-5); "
          f"L={one.arrays.slot_valid.shape[0]}", flush=True)
    check(dp1 <= 2e-5 and de1 <= 1e-5, "phase 3 disagrees")

    # the two level walks of the kernel on the ordered schedule (C <= 32,
    # where walk() picks the warp): 8 jittered dragons with a grab, 3 frames,
    # bit for bit in positions, velocities and vol_err
    walks = gs_fused.FusedGSBody(dragon, num_bodies=8, coloring="ordered",
                                 jitter=0.2)
    walks.set_grab(2, 100, [0.1, 1.4, 0.0])
    C = walks.arrays.slot_valid.shape[1]
    runs = {}
    for w in ("warp", "block"):
        pos, vel, out = walks.pos, walks.vel, []
        for _ in range(3):
            pos, _, vel, verr = gs_fused._gs_frame_cuda(
                pos, vel, walks.arrays, params, walks.grab_id,
                walks.grab_pos, level_walk=w)
            out += [pos, vel, verr]
        runs[w] = out
    sync()
    same = all(torch.equal(a, b) for a, b in zip(runs["warp"], runs["block"]))
    print(f"phase 3 ordered B=8 (C={C}, walk() = {gs_fused.walk(C)!r}): warp "
          f"walk vs block walk, 3 frames, positions, velocities and vol_err "
          f"bitwise {same}", flush=True)
    check(gs_fused.walk(C) == "warp", "the ordered schedule is not walked "
          "by a warp")
    check(same, "the warp and block walks differ")

    # a pinned particle (the predict gate) and two grabs on one body
    box = tt.grid_mesh(3, 3, 3, cell=0.25, origin=(-0.375, 0.5, -0.375))
    pinned = Body(box, pinned=[0])
    targets = [[0.2, 1.4, 0.1], [-0.3, 1.2, 0.0]]
    pinned.controls = tt.Controls(
        grab_id=torch.tensor([5, 40], dtype=torch.int32, device="cuda"),
        grab_pos=torch.tensor(targets, device="cuda"))
    s0 = pinned.state
    pinned.step_many(params, 2)
    pos, _, _ = plain(gs_fused, s0.pos[None], s0.vel[None], pinned.arrays,
                      params, pinned.controls.grab_id[None],
                      pinned.controls.grab_pos[None], 2)
    got = pinned.state.pos
    dp2 = max_diff(got, pos[0])
    print(f"phase 3 pinned + 2 grabs, ordered B=1 2 frames: kernel vs plain "
          f"max|dpos| {dp2:.3e} (tol 2e-5)", flush=True)
    check(dp2 <= 2e-5, "phase 3 pinned/grabs disagree")
    check(torch.equal(got[0], s0.pos[0]), "pinned particle moved")
    check(torch.equal(got[[5, 40]], torch.tensor(targets, device="cuda")),
          "grabbed particles off target")
    return max(dp, dp1, dp2)


def contact_vs_plain(tt, gs_fused, dragon, params):
    """Phase 3 in contact: the ground clamp, friction and the world's side
    bounds, kernel vs plain from the same state.  Returns the largest
    position difference."""
    from tetsim_torch.world import Body

    # one dragon resting on the ground after 120 frames, ordered, 1 frame
    # (a second frame from this state takes the kernel alone 6e-5 apart
    # from inputs 1 ulp apart, past the bound; see PERF.md)
    one = Body(dragon)
    one.step_many(params, 120)
    s0 = one.state
    one.step(params)
    rp, _, rerr = plain(gs_fused, s0.pos[None], s0.vel[None], one.arrays,
                        params, *no_grab(1), 1)
    ulp = torch.nextafter(s0.pos, torch.full_like(s0.pos, 10.0))
    kp, _, _, _ = gs_fused.gs_frame(ulp[None], s0.vel[None], one.arrays,
                                    params, *no_grab(1))
    dp1 = max_diff(one.state.pos, rp[0])
    de1 = max_diff(one.last_diag, rerr[0])
    dn1 = max_diff(one.state.pos, kp[0])
    ground = int((rp[0, :, 1] == 0).sum())
    print(f"phase 3 contact, ordered B=1 resting, 1 frame: kernel vs plain "
          f"max|dpos| {dp1:.3e} (tol 2e-5) max|dvol_err| {de1:.3e} "
          f"(tol 1e-5); kernel vs kernel from 1 ulp apart {dn1:.3e}; "
          f"{ground} particles on the ground", flush=True)
    check(ground > 0, "the resting dragon does not touch the ground")
    check(dp1 <= 2e-5 and de1 <= 1e-5, "phase 3 contact (ordered) disagrees")

    # 8 jittered dragons resting after 120 frames, greedy, 3 frames
    body = gs_fused.FusedGSBody(dragon, num_bodies=8, jitter=0.2)
    body.step(params, 120)
    pos, vel = body.pos, body.vel
    body.step(params, 3)
    pos, vel, err = plain(gs_fused, pos, vel, body.arrays, params,
                          body.grab_id, body.grab_pos, 3)
    dp8, dv8 = max_diff(body.pos, pos), max_diff(body.vel, vel)
    de8 = max_diff(body.last_diag, err)
    grounded = int((pos[..., 1] == 0).any(dim=1).sum())
    print(f"phase 3 contact, greedy B=8 resting, 3 frames: kernel vs plain "
          f"max|dpos| {dp8:.3e} (tol 2e-4) max|dvel| {dv8:.3e} (tol 2e-2) "
          f"max|dvol_err| {de8:.3e} (tol 1e-5); {grounded} of 8 bodies on "
          "the ground", flush=True)
    check(grounded == 8, "a resting dragon does not touch the ground")
    check(dp8 <= 2e-4 and dv8 <= 2e-2 and de8 <= 1e-5,
          "phase 3 contact (greedy) disagrees")

    # two dragons pushed past the side walls at friction k = dt * 30 = 0.1:
    # body 0 starts 2 mm past +x moving at +1 m/s; body 1 starts 2 mm past
    # -z and 2 mm below the ground, moving at -1 m/s in z
    slip = dataclasses.replace(params, friction=30.0)
    lo, hi = params.world_min, params.world_max
    v = dragon.verts
    shift = torch.tensor(
        [[hi[0] + 0.002 - v[:, 0].max(), 0.0, 0.0],
         [0.0, -0.002 - v[:, 1].min(), lo[2] - 0.002 - v[:, 2].min()]],
        dtype=torch.float32, device="cuda")
    wall = gs_fused.FusedGSBody(dragon, num_bodies=2)
    wall.pos = wall.pos + shift[:, None]
    wall.vel[0, :, 0] = 1.0
    wall.vel[1, :, 2] = -1.0
    pos, vel = wall.pos, wall.vel
    wall.step(slip, 2)
    pos, _, _ = plain(gs_fused, pos, vel, wall.arrays, slip, wall.grab_id,
                      wall.grab_pos, 2)
    dw = max_diff(wall.pos, pos)
    at_x = int((pos[0, :, 0] == float(hi[0])).sum())
    at_z = int((pos[1, :, 2] == float(lo[2])).sum())
    ground = int((pos[1, :, 1] == 0).sum())
    print(f"phase 3 contact, greedy B=2 past the walls, friction k=0.1, "
          f"2 frames: kernel vs plain max|dpos| {dw:.3e} (tol 2e-4); "
          f"{at_x} particles at +x, {at_z} at -z, {ground} on the ground",
          flush=True)
    check(at_x > 0 and at_z > 0 and ground > 0, "the walls were not reached")
    check(dw <= 2e-4, "phase 3 contact (walls) disagrees")
    return max(dp1, dp8, dw)


def main_path(tt, gs_fused, dragon):
    """Phase 4: returns (launches, seconds)."""
    from tetsim_torch.kernels import polar_fused

    params = tt.default_cpu_params()
    lo, hi = params.world_min - 1e-5, params.world_max + 1e-5
    gs_fused.launch_count = polar_fused.launch_count = 0
    t0 = time.perf_counter()

    world = tt.World(tt.default_cpu_params())
    body = world.add_body(dragon)
    with no_host_sync():
        world.step(120)
    pid = body.start_grab([0.0, 1.0, 0.5])
    target = np.float32([0.0, 1.5, 0.5])
    body.move_grabbed(target)
    world.step(30)
    pos = body.positions
    body.end_grab()
    verts, normals, tris = body.surface_mesh()
    diag = world.diagnostics()["body0"]
    check(gs_fused.launch_count == 150,
          f"Body: {gs_fused.launch_count} kernel launches for 150 frames")
    check(np.isfinite(pos).all() and pos.shape == (1234, 3), "Body positions")
    check(pos[:, 1].min() >= -1e-5, "Body below the ground")
    check(((pos >= lo) & (pos <= hi)).all(), "Body outside the world bounds")
    check(np.abs(pos[pid] - target).max() <= 1e-6, "grabbed particle off target")
    check(verts.shape == (29800, 3) and tris.shape == (59657, 3), "surface shape")
    check(np.isfinite(verts).all(), "surface not finite")
    check(np.abs(np.linalg.norm(normals, axis=1) - 1.0).max() < 1e-4, "normals")
    check(not diag["nan"] and diag["min_height"] >= -1e-5, f"diagnostics {diag}")
    print(f"phase 4 World/Body: 150 frames, {gs_fused.launch_count} launches, "
          f"grab pid {pid} at target, min y {diag['min_height']:.4f}, "
          f"volume_error {diag['volume_error']:.3e}", flush=True)

    world = tt.World(tt.default_cpu_params())
    batch = world.add_body_batch(dragon, 8, engine="neohookean", backend="fused")
    with no_host_sync():
        world.step(120)
    bpid = batch.start_grab(3, [0.0, 1.0, 0.5])
    batch.move_grabbed(3, target)
    world.step(30)
    bpos = batch.positions()
    batch.end_grab(3)
    bdiag = world.diagnostics()["body0"]
    seconds = time.perf_counter() - t0
    check(gs_fused.launch_count == 300,
          f"batch: {gs_fused.launch_count - 150} kernel launches for 150 frames")
    check(polar_fused.launch_count == 0, "the Neo-Hookean path ran polar_frame")
    check(np.isfinite(bpos).all() and bpos.shape == (8, 1234, 3), "batch positions")
    check(bpos[..., 1].min() >= -1e-5, "batch below the ground")
    check(((bpos >= lo) & (bpos <= hi)).all(), "batch outside the world bounds")
    check(np.abs(bpos[3, bpid] - target).max() <= 1e-6, "batch grab off target")
    check(np.array_equal(bpos[0], bpos[7]), "ungrabbed bodies differ")
    check(not bdiag["nan"] and bdiag["batch"] == 8, f"diagnostics {bdiag}")
    print(f"phase 4 add_body_batch x8: 150 frames, {gs_fused.launch_count - 150} "
          f"launches, grab pid {bpid} of body 3 at target, min y "
          f"{bdiag['min_height']:.4f}; both worlds {seconds:.2f} s", flush=True)
    return gs_fused.launch_count, seconds


def per_frame(step, state_sum, k1, k2):
    """Two-point fit over k1 and k2 frames, each run ending in a
    data-dependent sync (a device sum brought to the host)."""
    step(1)
    float(state_sum())  # warm-up

    def run(k):
        t0 = time.perf_counter()
        step(k)
        float(state_sum())
        return time.perf_counter() - t0

    return (run(k2) - run(k1)) / (k2 - k1)


def timings(tt, gs_fused, dragon, label):
    """Phase 5: returns {case: (kernel ms/frame, plain ms/frame)}."""
    from tetsim_torch.world import Body

    params = tt.default_cpu_params()
    out = {}
    cases = (("B=1 greedy", 1, True), ("B=8 greedy", 8, True),
             ("B=1 ordered", 1, False))
    for name, b, greedy in cases:
        if greedy:
            body = gs_fused.FusedGSBody(dragon, num_bodies=b)
            arrays, gid, gpos = body.arrays, body.grab_id, body.grab_pos
            k_ms = per_frame(lambda k: body.step(params, k),
                             lambda: body.pos.sum(), 50, 550)
            pos, vel = body.pos, body.vel
        else:
            body = Body(dragon)
            arrays = body.arrays
            gid, gpos = no_grab(1)
            k_ms = per_frame(lambda k: body.step_many(params, k),
                             lambda: body.state.pos.sum(), 20, 120)
            pos, vel = body.state.pos[None], body.state.vel[None]
        plain = {"pos": pos, "vel": vel}

        def plain_step(k):
            for _ in range(k):
                plain["pos"], _, plain["vel"], _ = gs_fused.gs_frame_reference(
                    plain["pos"], plain["vel"], arrays, params, gid, gpos)

        kp = (1, 2) if not greedy else (2, 8)
        p_ms = per_frame(plain_step, lambda: plain["pos"].sum(), *kp)
        k_ms, p_ms = k_ms * 1e3, p_ms * 1e3
        out[name] = (k_ms, p_ms)
        s = params.num_substeps
        L, C = arrays.slot_valid.shape
        print(f"phase 5 [{label}] dragon {name}: kernel {s / k_ms * 1e3:.1f} "
              f"substeps/s ({k_ms:.4f} ms/frame, {k_ms * 1e3 / (L * s):.4f} "
              f"us per level of {L}, {gs_fused.walk(C)} walk), plain torch "
              f"{s / p_ms * 1e3:.1f} substeps/s ({p_ms:.4f} ms/frame)",
              flush=True)
    return out


# -- the polar frame kernel (K2) ----------------------------------------------

def polar_plain(polar_fused, pos, vel, quats, arrays, params, gid, gpos,
                frames):
    """``frames`` frames of the plain polar twin; returns (pos, vel, quats)."""
    for _ in range(frames):
        pos, _, vel, quats = polar_fused.polar_frame_reference(
            pos, vel, quats, arrays, params, gid, gpos)
    sync()
    return pos, vel, quats


def polar_case(polar_fused, body, params, frames, tol, label):
    """The kernel vs its plain twin from ``body``'s state, after each of
    ``frames`` frames, beside the kernel's own spread from positions 1 ulp
    apart, and a bitwise repeat.  Positions are held to ``tol`` and
    velocities to 2e-2 after every frame; quaternions to ``tol`` or twice
    the kernel's own quaternion spread, whichever is larger: the kernel
    contracts multiply-adds into FMAs where the twin rounds every product,
    and the dragon amplifies those last-bit differences as it amplifies a
    1-ulp change.  Returns the largest position difference."""
    pos, vel, quats = body.pos, body.vel, body.quats
    args = (body.arrays, params, body.grab_id, body.grab_pos)

    def run(frame, p):
        out, v, q = [], vel, quats
        for _ in range(frames):
            p, _, v, q = frame(p, v, q, *args)
            out.append((p, v, q))
        sync()
        return out

    got = run(polar_fused.polar_frame, pos)
    want = run(polar_fused.polar_frame_reference, pos)
    # every cluster size the card runs, each bit for bit cs = 1
    waves = polar_fused.active_clusters(pos.device, pos.shape[1])
    sizes = [cs for cs, count in waves.items() if count >= 1]
    by_cs = {cs: run(functools.partial(polar_fused._polar_frame_cuda, cs=cs),
                     pos) for cs in sizes}
    same = {cs: all(torch.equal(a, b) for f, g in zip(by_cs[cs], by_cs[1])
                    for a, b in zip(f, g)) for cs in sizes}
    auto = polar_fused.cluster_size(pos.shape[0], polar_fused.MAX_CLUSTER,
                                    waves)
    print(f"phase 6 polar {label}: cluster sizes {sizes} (this batch takes "
          f"{auto}), each vs cs=1 after every frame, bitwise: {same}",
          flush=True)
    check(all(same.values()), f"polar {label}: a cluster size differs from 1")
    check(all(torch.equal(a, b) for f, g in zip(got, by_cs[auto])
              for a, b in zip(f, g)), f"polar {label}: polar_frame is not "
          f"its cluster size {auto}")
    moved = run(polar_fused.polar_frame,
                torch.nextafter(pos, torch.full_like(pos, 10.0)))
    again = run(polar_fused.polar_frame, pos)[-1]
    worst = 0.0
    for f, (k, r, m) in enumerate(zip(got, want, moved), 1):
        dp, dv, dq = (max_diff(a, b) for a, b in zip(k, r))
        sp, sq = max_diff(k[0], m[0]), max_diff(k[2], m[2])
        qtol = max(tol, 2 * sq)
        print(f"phase 6 polar {label}, frame {f} of {frames} at "
              f"{params.num_substeps} substeps: kernel vs plain max|dpos| "
              f"{dp:.3e} (tol {tol:g}) max|dquat| {dq:.3e} (tol {qtol:.3e}) "
              f"max|dvel| {dv:.3e} (tol 2e-2); kernel vs kernel from 1 ulp "
              f"apart: pos {sp:.3e}, quat {sq:.3e}", flush=True)
        check(dp <= tol and dq <= qtol and dv <= 2e-2,
              f"polar {label} disagrees after frame {f}")
        worst = max(worst, dp)
    same = all(torch.equal(a, b) for a, b in zip(again, got[-1]))
    print(f"phase 6 polar {label}: repeat bitwise {same}", flush=True)
    check(same, f"polar {label}: two runs from one input differ")
    body.pos, body.vel, body.quats = got[-1]
    return worst


def polar_vs_plain(tt, polar_fused, dragon):
    """Phase 6: returns the largest position difference."""
    params = tt.default_gpu_params()
    top = np.argsort(-dragon.verts[:, 1])[:3].tolist()  # 3 pinned particles
    body = polar_fused.FusedPolarBody(dragon, 8, jitter=0.2, pinned=top)
    start = body.pos
    body.set_grab(3, 100, start[3, 100].cpu().numpy() + np.float32([0, 0.05, 0]))
    errs = [polar_case(polar_fused, body, params, 3, 2e-5,
                       "B=8 jittered, 3 pinned, grab on body 3")]
    check(torch.equal(body.pos[:, top], start[:, top]), "pinned particles moved")
    check(torch.equal(body.pos[3, 100], body.grab_pos[3, 0]), "grab off target")

    rest = polar_fused.FusedPolarBody(dragon, 8, jitter=0.2)
    rest.step(params, 120)
    errs.append(polar_case(polar_fused, rest, params, 1, 2e-5,
                           "B=8 resting on the ground"))
    grounded = int((rest.pos[..., 1] == 0).any(dim=1).sum())
    print(f"phase 6 polar resting: {grounded} of 8 bodies on the ground",
          flush=True)
    check(grounded == 8, "a resting dragon does not touch the ground")

    # two dragons past the walls at friction k = dt * 120 = 0.1
    slip = dataclasses.replace(params, friction=0.1 / float(params.dt))
    lo, hi = params.world_min, params.world_max
    v = dragon.verts
    wall = polar_fused.FusedPolarBody(dragon, 2)
    wall.pos = wall.pos + torch.tensor(
        [[hi[0] + 0.002 - v[:, 0].max(), 0.0, 0.0],
         [0.0, -0.002 - v[:, 1].min(), lo[2] - 0.002 - v[:, 2].min()]],
        dtype=torch.float32, device="cuda")[:, None]
    wall.vel[0, :, 0] = 1.0
    wall.vel[1, :, 2] = -1.0
    errs.append(polar_case(polar_fused, wall, slip, 2, 2e-4,
                           f"B=2 past the walls, friction k={float(slip.dt * slip.friction):.3f}"))
    at_x = int((wall.pos[0, :, 0] == float(hi[0])).sum())
    at_z = int((wall.pos[1, :, 2] == float(lo[2])).sum())
    ground = int((wall.pos[1, :, 1] == 0).sum())
    print(f"phase 6 polar walls: {at_x} particles at +x, {at_z} at -z, "
          f"{ground} on the ground", flush=True)
    check(at_x > 0 and at_z > 0 and ground > 0, "the walls were not reached")

    big = tt.grid_mesh(40, 40, 40, cell=0.02)
    try:
        polar_fused.FusedPolarBody(big, 1)
    except ValueError as e:
        print(f"phase 6 polar shared-memory refusal ({big.num_particles} "
              f"particles): {e}", flush=True)
    else:
        raise AssertionError("a mesh over the shared memory was accepted")
    return max(errs)


def polar_main_path(tt, polar_fused, gs_fused, dragon):
    """Phase 7: returns the launches of all three scenes."""
    params = tt.default_gpu_params()
    lo, hi = params.world_min - 1e-5, params.world_max + 1e-5
    target = np.float32([0.0, 1.5, 0.5])
    launches = 0

    def scene(label, add, batched):
        nonlocal launches
        gs_fused.launch_count = polar_fused.launch_count = 0
        t0 = time.perf_counter()
        world = tt.World(tt.default_gpu_params())
        check(world.device.type == "cuda", "World() is not on the card")
        body = add(world)
        with no_host_sync():
            world.step(120)
        if batched:
            pid = body.start_grab(3, [0.0, 1.0, 0.5])
            body.move_grabbed(3, target)
        else:
            pid = body.start_grab([0.0, 1.0, 0.5])
            body.move_grabbed(target)
        world.step(30)
        fused = type(body) is polar_fused.FusedPolarBody  # no surface
        pos = body.positions() if fused else body.positions
        if batched:
            body.end_grab(3)
        else:
            body.end_grab()
        diag = world.diagnostics()["body0"]
        meshes = {} if fused else {n: body.surface_mesh(normals=n)
                                   for n in ("smooth", "rotated")}
        count = polar_fused.launch_count
        check(count == 150, f"{label}: {count} kernel launches for 150 frames")
        check(gs_fused.launch_count == 0, f"{label} ran gs_frame")
        b = 8 if batched else 1
        pos = pos.reshape(b, 1234, 3)
        check(np.isfinite(pos).all(), f"{label} positions not finite")
        check(pos[..., 1].min() >= -1e-5, f"{label} below the ground")
        check(((pos >= lo) & (pos <= hi)).all(), f"{label} outside the world")
        grabbed = pos[3 if batched else 0, pid]
        check(np.abs(grabbed - target).max() <= 1e-6, f"{label} grab off target")
        if batched:
            check(np.array_equal(pos[0], pos[7]), f"{label}: ungrabbed bodies differ")
        for n, (verts, normals, tris) in meshes.items():
            check(verts.shape == (29800 * b, 3) and tris.shape == (59657 * b, 3),
                  f"{label} {n} surface shape")
            check(np.isfinite(verts).all() and np.isfinite(normals).all(),
                  f"{label} {n} surface not finite")
            check(np.abs(np.linalg.norm(normals, axis=1) - 1.0).max() < 1e-4,
                  f"{label} {n} normals")
        check(not diag["nan"] and diag["min_height"] >= -1e-5,
              f"{label} diagnostics {diag}")
        launches += count
        shadings = (f", surfaces {sorted(meshes)} finite with unit normals"
                    if meshes else "")
        print(f"phase 7 {label}: 150 frames, {count} launches, grab pid {pid} "
              f"at target, min y {diag['min_height']:.4f}{shadings}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    scene("World/Body(engine='polar')",
          lambda w: w.add_body(dragon, engine="polar"), False)
    scene("add_body_batch(dragon, 8) (polar, flat)",
          lambda w: w.add_body_batch(dragon, 8), True)
    scene("add_body_batch(dragon, 8, backend='fused') (polar)",
          lambda w: w.add_body_batch(dragon, 8, engine="polar",
                                     backend="fused"), True)
    return launches


def polar_timings(tt, polar_fused, dragon, label):
    """Phase 8: returns {case: (kernel ms/frame, plain ms/frame)}."""
    from tetsim_torch.world import Body

    params = tt.default_gpu_params()
    out = {}
    waves = polar_fused.active_clusters(torch.device("cuda", 0),
                                        dragon.num_particles)
    for name, b in (("B=1 Body", 1), ("B=8", 8), ("B=132", 132)):
        if b == 1:
            body = Body(dragon, engine="polar")
            k_ms = per_frame(lambda k: body.step_many(params, k),
                             lambda: body.state.pos.sum(), 20, 120)
            st = body.state
            args = (st.pos[None], st.vel[None], st.quats[None], body.arrays)
            gid, gpos = no_grab(1)
        else:
            body = polar_fused.FusedPolarBody(dragon, b)
            k_ms = per_frame(lambda k: body.step(params, k),
                             lambda: body.pos.sum(), 20, 120)
            args = (body.pos, body.vel, body.quats, body.arrays)
            gid, gpos = body.grab_id, body.grab_pos
        plain = {"pos": args[0], "vel": args[1], "quats": args[2]}

        def plain_step(k):
            for _ in range(k):
                plain["pos"], _, plain["vel"], plain["quats"] = \
                    polar_fused.polar_frame_reference(
                        plain["pos"], plain["vel"], plain["quats"], args[3],
                        params, gid, gpos)

        p_ms = per_frame(plain_step, lambda: plain["pos"].sum(), 1, 3)
        k_ms, p_ms = k_ms * 1e3, p_ms * 1e3
        out[name] = (k_ms, p_ms)
        s = params.num_substeps
        cs = polar_fused.cluster_size(b, polar_fused.MAX_CLUSTER, waves)
        print(f"phase 8 [{label}] polar dragon {name}, {s} substeps/frame, "
              f"cluster size {cs}: kernel {s / k_ms * 1e3:.1f} substeps/s per "
              f"body ({k_ms:.4f} ms/frame, {k_ms * 1e3 / s:.3f} us per "
              f"substep, {b * s / k_ms * 1e3:.1f} body-substeps/s), plain "
              f"torch {s / p_ms * 1e3:.1f} substeps/s ({p_ms:.4f} ms/frame)",
              flush=True)
    body = polar_fused.FusedPolarBody(dragon, 1)
    for cs, count in waves.items():
        if count < 1:
            continue
        state = [body.pos, body.vel, body.quats]

        def step(k, cs=cs):
            for _ in range(k):
                p, _, v, q = polar_fused._polar_frame_cuda(
                    *state, body.arrays, params, body.grab_id, body.grab_pos,
                    cs=cs)
                state[:] = p, v, q

        ms = per_frame(step, lambda: state[0].sum(), 20, 120) * 1e3
        print(f"phase 8 [{label}] polar dragon B=1 at cluster size {cs} "
              f"({count} such clusters at once): {ms:.4f} ms/frame, "
              f"{ms * 1e3 / params.num_substeps:.3f} us per substep",
              flush=True)
    return out


# -- the grid stencil kernels (K4, K3) ----------------------------------------

GRID = (56, 56, 56)  # bench.py's scale box: 1,053,696 tets
GRID_BOX = dict(cell=0.02, origin=(-0.56, 0.5, -0.56))
GRID_SUBSTEPS = 5  # examples/scale_grid.py's default


def grid_box(tt, polar, dims, cell, origin, pins=None, num_bodies=1,
             vel=0.0, seed=0):
    """(arrays, pos, vel, quats or None) for ``num_bodies`` copies of a
    grid box in the kernels' layout, velocities seeded in +-vel."""
    from tetsim_torch.solvers import neohookean_grid, polar_grid

    mesh = tt.grid_mesh(*dims, cell=cell, origin=origin)
    build = (polar_grid.build_grid_arrays if polar
             else neohookean_grid.build_nh_grid_arrays)
    arr = build(mesh, dims, pinned=pins, device="cuda")
    n = mesh.num_particles
    pos = torch.tensor(mesh.verts, device="cuda").T.contiguous()
    pos = pos[None].repeat(num_bodies, 1, 1)
    rng = np.random.RandomState(seed)
    v = torch.tensor(rng.uniform(-vel, vel, (num_bodies, 3, n)).astype(
        np.float32), device="cuda")
    quats = None
    if polar:
        quats = torch.zeros((num_bodies, 6, 4, arr.num_tets // 6),
                            device="cuda")
        quats[:, :, 3] = 1.0
    return arr, pos, v, quats


def grid_case(mod, arr, start, params, gid, gpos, frames, tol, label,
              by_spread=False):
    """The kernel vs its plain twin from ``start`` = (pos, vel[, quats])
    after each of ``frames`` frames, beside the kernel's own spread from
    positions 1 ulp apart.  Positions are held to ``tol``; polar
    quaternions to 2e-5 or twice the kernel's quaternion spread, whichever
    is larger, velocities to 2e-2; Neo-Hookean velocities to 2e-3 and the
    volume error to 1e-5.  ``by_spread``: every bound is twice the kernel's
    own spread where that is larger (contact with friction, and the
    collapsing Neo-Hookean scale box, turn a last-bit difference into
    more).  Returns (largest position difference, the last frame's kernel
    output)."""
    polar = len(start) == 3
    kw = {} if polar else {"vol_err": True}

    def run(frame, pos):
        out, s = [], (pos,) + start[1:]
        for _ in range(frames):
            r = frame(*s, arr, params, gid, gpos, **kw)
            out.append(r)
            s = (r[0], r[2]) + ((r[3],) if polar else ())
        sync()
        return out

    pos = start[0]
    got = run(mod.grid_frame, pos)
    want = run(mod.grid_frame_reference, pos)
    moved = run(mod.grid_frame, torch.nextafter(pos, torch.full_like(pos, 10.0)))
    worst = 0.0
    for f, (k, r, m) in enumerate(zip(got, want, moved), 1):
        dp, dv, d3 = (max_diff(k[i], r[i]) for i in (0, 2, 3))
        sp, sv, s3 = (max_diff(k[i], m[i]) for i in (0, 2, 3))
        if polar:
            t3, vtol, what = max(2e-5, 2 * s3), 2e-2, "quat"
        else:
            t3, vtol, what = 1e-5, 2e-3, "vol_err"
        ptol = tol
        if by_spread:
            ptol, vtol, t3 = max(ptol, 2 * sp), max(vtol, 2 * sv), max(t3, 2 * s3)
        print(f"phase 9 {mod.__name__.split('.')[-1]} {label}, frame {f} of "
              f"{frames}: kernel vs plain max|dpos| {dp:.3e} (tol {ptol:.3e}) "
              f"max|d{what}| {d3:.3e} (tol {t3:.3e}) max|dvel| {dv:.3e} (tol "
              f"{vtol:.3e}); kernel vs kernel from 1 ulp apart: pos {sp:.3e}, "
              f"vel {sv:.3e}, {what} {s3:.3e}", flush=True)
        check(dp <= ptol and d3 <= t3 and dv <= vtol,
              f"{label} disagrees after frame {f}")
        worst = max(worst, dp)
    return worst, got[-1]


def grid_vs_plain(tt, mod):
    """Phase 9 for one kernel module; returns the largest position
    difference."""
    polar = mod.__name__.endswith("polar_stencil")
    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    errs = []
    for dims, pins, grab in (((4, 3, 2), [0, 5], 7), ((12, 9, 7), [0, 50], 100)):
        box = grid_box(tt, polar, dims, 0.05, (-0.2, 0.5, -0.15), pins=pins,
                       vel=0.3, seed=1)
        target = box[1][0, :, grab] + torch.tensor([0.0, 0.05, 0.02],
                                                   device="cuda")
        gid = torch.tensor([[grab]], dtype=torch.int32, device="cuda")
        err, out = grid_case(mod, box[0], box[1:] if polar else box[1:3],
                             params, gid, target[None, None], 3, 2e-5,
                             f"{dims} 2 pinned, grab")
        check(torch.equal(out[0][0][:, pins], box[1][0][:, pins]),
              "pinned particles moved")
        check(torch.equal(out[0][0, :, grab], target), "grab off target")
        errs.append(err)

    # a box resting on the ground after 60 frames, 1 frame
    arr, pos, vel, quats = grid_box(tt, polar, (12, 9, 7), 0.05,
                                    (-0.3, 0.05, -0.2))
    gid, gpos = no_grab(1)
    for _ in range(60):
        out = mod.grid_frame(pos, vel, *((quats,) if polar else ()), arr,
                             params, gid, gpos)
        pos, vel = out[0], out[2]
        quats = out[3] if polar else None
    start = (pos, vel, quats) if polar else (pos, vel)
    err, out = grid_case(mod, arr, start, params, gid, gpos, 1, 2e-5,
                         "(12, 9, 7) resting on the ground")
    ground = int((out[0][0, 1] == 0).sum())
    print(f"phase 9 resting: {ground} particles on the ground", flush=True)
    check(ground > 0, "the resting box does not touch the ground")
    errs.append(err)

    # two boxes past the walls at friction k = dt * friction = 0.1: box 0
    # 2 mm past +x moving at +1 m/s, box 1 2 mm past -z and below the
    # ground moving at -1 m/s in z
    slip = dataclasses.replace(params, friction=0.1 / float(params.dt))
    lo, hi = params.world_min, params.world_max
    arr, pos, vel, quats = grid_box(tt, polar, (12, 9, 7), 0.05,
                                    (0.0, 0.5, 0.0), num_bodies=2)
    pos = pos.clone()
    pos[0, 0] += float(hi[0]) + 0.002 - pos[0, 0].max()
    pos[1, 1] += -0.002 - pos[1, 1].min()
    pos[1, 2] += float(lo[2]) - 0.002 - pos[1, 2].min()
    vel[0, 0], vel[1, 2] = 1.0, -1.0
    gid, gpos = no_grab(2)
    start = (pos, vel, quats) if polar else (pos, vel)
    err, out = grid_case(mod, arr, start, slip, gid, gpos, 2, 2e-5,
                         "2 boxes past the walls, friction k=0.100",
                         by_spread=True)
    at_x = int((out[0][0, 0] == float(hi[0])).sum())
    at_z = int((out[0][1, 2] == float(lo[2])).sum())
    ground = int((out[0][1, 1] == 0).sum())
    print(f"phase 9 walls: {at_x} particles at +x, {at_z} at -z, {ground} "
          "on the ground", flush=True)
    check(at_x > 0 and at_z > 0 and ground > 0, "the walls were not reached")
    errs.append(err)

    # the 56^3 box, 1 frame, at cell 0.05 and at the scale box's cell 0.02.
    # There the Neo-Hookean engine collapses its tets (vol_err near -1) and
    # a 1-ulp change moves it by a tenth from rest, as the JAX engine does:
    # that case starts at rest, as the scale box does, and is held by its
    # spread
    gid, gpos = no_grab(1)
    for cell, origin in ((0.05, (-1.4, 0.1, -1.4)),
                         (GRID_BOX["cell"], GRID_BOX["origin"])):
        collapses = not polar and cell == GRID_BOX["cell"]
        arr, pos, vel, quats = grid_box(tt, polar, GRID, cell, origin,
                                        vel=0.0 if collapses else 0.1, seed=2)
        start = (pos, vel, quats) if polar else (pos, vel)
        err, _ = grid_case(mod, arr, start, params, gid, gpos, 1, 2e-5,
                           f"{GRID} ({arr.num_tets} tets) cell {cell}",
                           by_spread=collapses)
        if not collapses:
            errs.append(err)
    return max(errs)


def grid_main_path(tt, kernels):
    """Phase 10: returns each grid kernel's launches in all scenes."""
    from tetsim_torch.kernels import nh_stencil, polar_stencil

    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    lo, hi = params.world_min - 1e-5, params.world_max + 1e-5
    target = np.float32([0.0, 1.3, 0.0])
    n = (GRID[0] + 1) * (GRID[1] + 1) * (GRID[2] + 1)
    frames = (60, 20)
    launches = {polar_stencil: 0, nh_stencil: 0}
    # each kernel's launches per frame from its own constant: K4 2 per
    # substep, K3 one cooperative launch per frame
    per_frame = {
        polar_stencil: GRID_SUBSTEPS * polar_stencil.LAUNCHES_PER_SUBSTEP,
        nh_stencil: nh_stencil.LAUNCHES_PER_FRAME}
    scenes = [(e, p) for e in ("polar_grid", "polar_grid_pallas",
                               "neohookean_grid", "neohookean_grid_pallas")
              for p in ((False, True) if e.endswith("_pallas") else (False,))]
    scenes += [("polar_grid", "batch"), ("neohookean_grid", "batch")]
    for engine, packed in scenes:
        for m in kernels.values():
            m.launch_count = 0
        t0 = time.perf_counter()
        world = tt.World(params)
        batched = packed == "batch"
        if batched:
            body = world.add_grid_body_batch(GRID, 2, engine=engine,
                                             cell=GRID_BOX["cell"])
        else:
            body = world.add_grid_body(GRID, engine=engine, packed=packed,
                                       **GRID_BOX)
        with no_host_sync():
            world.step(frames[0])
        if batched:
            pid = body.start_grab(1, [0.0, 1.2, 0.0])
            body.move_grabbed(1, target)
        else:
            pid = body.start_grab([0.0, 1.2, 0.0])
            body.move_grabbed(target)
        with no_host_sync():
            world.step(frames[1])
        pos = body.positions.reshape(-1, n, 3)
        diag = world.diagnostics()["body0"]
        seconds = time.perf_counter() - t0
        mod = polar_stencil if engine.startswith("polar") else nh_stencil
        want = sum(frames) * per_frame[mod]
        label = f"{engine} {'batch of 2' if batched else f'packed={packed}'}"
        check(mod.launch_count == want,
              f"{label}: {mod.launch_count} launches, expected {want}")
        others = {k: m.launch_count for k, m in kernels.items()
                  if m is not mod and m.launch_count}
        check(not others, f"{label} launched {others}")
        check(np.isfinite(pos).all(), f"{label} positions not finite")
        check(pos[..., 1].min() >= -1e-5, f"{label} below the ground")
        check(((pos >= lo) & (pos <= hi)).all(), f"{label} outside the world")
        check(np.array_equal(pos[1 if batched else 0, pid], target),
              f"{label} grab off target")
        check(not diag["nan"], f"{label} diagnostics {diag}")
        sve = diag.get("solver_vol_error")
        if not batched:  # 0 / mean det F - 1 per substep, NaN (left out)
            check((sve is not None) == (engine in ("polar_grid",
                                                   "neohookean_grid")),
                  f"{label} solver_vol_error {sve}")
        launches[mod] += mod.launch_count
        print(f"phase 10 {label}: {sum(frames)} frames at {GRID_SUBSTEPS} "
              f"substeps, {mod.launch_count} launches, grab pid {pid} at "
              f"target, min y {diag['min_height']:.4f}"
              + (f", volume_error {diag['volume_error']:.3e}" if not batched
                 else "")
              + (f", solver_vol_error {sve:.3e}" if sve is not None else "")
              + f"; {seconds:.2f} s", flush=True)
    return launches


def grid_timings(tt, mod, label):
    """Phase 11: (kernel ms per substep, plain ms per substep) at 56^3."""
    polar = mod.__name__.endswith("polar_stencil")
    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    arr, pos, vel, quats = grid_box(tt, polar, GRID, **GRID_BOX)
    gid, gpos = no_grab(1)
    out = {}
    for name, frame, k1, k2 in (("kernel", mod.grid_frame, 20, 120),
                                ("plain", mod.grid_frame_reference, 1, 3)):
        st = {"s": (pos, vel) + ((quats,) if polar else ())}

        def step(k):
            for _ in range(k):
                r = frame(*st["s"], arr, params, gid, gpos)
                st["s"] = (r[0], r[2]) + ((r[3],) if polar else ())

        out[name] = per_frame(step, lambda: st["s"][0].sum(), k1, k2) \
            * 1e3 / GRID_SUBSTEPS
    kname = mod.__name__.split(".")[-1]
    per_phase = ("" if polar else
                 f", {out['kernel'] * 1e3 / (mod.COLORS + 1):.3f} us per "
                 f"phase (48 colour phases, each item waiting on its "
                 f"neighbours, and a particle phase between two grid "
                 f"barriers, on {mod.frame_grid(pos.device)} blocks)")
    print(f"phase 11 [{label}] {kname} at {GRID} ({arr.num_tets} tets): "
          f"kernel {out['kernel']:.4f} ms/substep "
          f"({1e3 / out['kernel']:.1f} substeps/s){per_phase}, plain torch "
          f"{out['plain']:.4f} ms/substep", flush=True)
    one = dataclasses.replace(params, num_substeps=1)
    if polar:
        work = (mod.frame_flops(arr, one, 1), mod.frame_bytes(arr, 1, 1))
    else:
        work = (mod.frame_flops(arr, one, 1), mod.frame_bytes(arr, one, 1, 1))
    return out["kernel"], out["plain"], bound(*work)


# -- the pieces kernels (K6, K5) ----------------------------------------------

BLOB = dict(n=68, radii=(0.68, 0.68, 0.68), center=(0.0, 0.75, 0.0))  # bench.py
BLOB_MID = dict(n=27, radii=(0.68, 0.68, 0.68), center=(0.0, 0.75, 0.0))
BLOB_SMALL = dict(n=10, radii=(0.4, 0.35, 0.45))  # tests_tpu's blob
PIECES_TPP = 2048  # bench.py's tets_per_piece
PIECES_SUBSTEPS = 5


@dataclasses.dataclass(frozen=True)
class PiecesEngine:
    """One pieces engine as phases 12-14 drive it, named once in ``main``."""

    mod: object  # the kernel module (launch_count, frame_flops, frame_bytes)
    build: Callable  # (mesh, tets_per_piece=, pinned=, boundary_prefix=,
    #                   device=) -> arrays
    make: Callable  # arrays -> (pack, step, unpack, unpack_pos), the kernel's
    twin: Callable  # arrays -> the same with the plain twin
    timed: Callable  # (arrays, packed, params) -> (kernel call, the plain
    #                  twin's call, substeps per call)
    per_frame: int  # kernel launches per frame at PIECES_SUBSTEPS
    describe: Callable  # arrays -> their engine's own table shapes
    vel_tol: float
    quats: bool  # the packed state ends in the quaternions, held at 2e-5
    # the engine collapses the 987k blob at cell 0.02 (PERF.md), so its whole
    # frames there are held only by their spread and one substep with a
    # softer material is held strictly instead
    collapses: bool
    replaces: str  # the TPU kernel, under tetsim_tpu/kernels/

    @property
    def name(self) -> str:
        return self.mod.__name__.split(".")[-1]


def pieces_engines():
    """K6's engine (polar_pieces), then K5's (nh_pieces)."""
    from tetsim_torch.kernels import nh_pieces as nh, polar_pieces as pp

    def k6_calls(arr, packed, params):
        args = (*packed[:3], packed[6], arr, params.extract_iters)
        return (lambda: pp.pieces_solve(*args),
                lambda: pp.pieces_solve_reference(*args), 1)

    def k5_calls(arr, packed, params):
        gid, gpos = (x[0] for x in no_grab(1))
        return (lambda: nh.nh_pieces_frame(packed, arr, params, gid, gpos),
                lambda: nh.nh_pieces_frame_reference(packed, arr, params, gid,
                                                     gpos),
                params.num_substeps)

    return (
        PiecesEngine(pp, pp.build_pieces_arrays, pp.make_pieces_stepper,
                     lambda a: pp.make_pieces_stepper(
                         a, solve=pp.pieces_solve_reference), k6_calls,
                     PIECES_SUBSTEPS * pp.LAUNCHES_PER_SUBSTEP,
                     lambda a: f"rt {a.rt}, K {a.valence}", vel_tol=2e-2,
                     quats=True, collapses=False,
                     replaces="polar_pieces.py:422"),
        PiecesEngine(nh, nh.build_nh_pieces_arrays, nh.make_nh_pieces_stepper,
                     lambda a: nh.make_nh_pieces_stepper(
                         a, frame=nh.nh_pieces_frame_reference), k5_calls,
                     nh.LAUNCHES_PER_FRAME, lambda a: f"l_max {a.l_max}",
                     vel_tol=2e-3, quats=False, collapses=True,
                     replaces="nh_pieces.py:250"),
    )


def pieces_case(e, arr, state, params, controls, frames, label):
    """The kernel's frames vs the plain twin's, from ``state`` in piece
    planes, after each of ``frames`` frames, beside the kernel's own spread
    from positions 1 ulp apart; the kernel launches ``e.per_frame`` times a
    frame (at ``PIECES_SUBSTEPS``).  Positions and polar quaternions are
    held to 2e-5, velocities to 2e-2 (polar) or 2e-3 (Neo-Hookean); each
    bound is at least twice the spread.  Returns (largest position
    difference, the last packed kernel state)."""
    pack, kstep, _, _ = e.make(arr)
    _, pstep, _, _ = e.twin(arr)

    def run(step, s):
        out, packed = [], pack(s, params)
        before = e.mod.launch_count
        for _ in range(frames):
            packed = step(packed, params, controls)
            out.append(packed)
        sync()
        if step is kstep and params.num_substeps == PIECES_SUBSTEPS:
            n = e.mod.launch_count - before
            check(n == frames * e.per_frame,
                  f"{e.name} {label}: {n} launches for {frames} frames")
        return out

    moved = state.replace(pos=torch.nextafter(state.pos,
                                              torch.full_like(state.pos, 10.0)))
    got, want, spread = run(kstep, state), run(pstep, state), run(kstep, moved)
    groups = (("pos", 0, 3, 2e-5), ("vel", 3, 6, e.vel_tol))
    groups += (("quat", 6, 7, 2e-5),) if e.quats else ()
    worst = 0.0
    for f, (k, r, m) in enumerate(zip(got, want, spread), 1):
        parts = []
        ok = True
        for what, lo, hi, tol in groups:
            d = max(max_diff(k[i], r[i]) for i in range(lo, hi))
            s = max(max_diff(k[i], m[i]) for i in range(lo, hi))
            t = max(tol, 2 * s)
            ok = ok and d <= t
            parts.append(f"max|d{what}| {d:.3e} (tol {t:.3e}, 1-ulp spread "
                         f"{s:.3e})")
            if what == "pos":
                worst = max(worst, d)
        print(f"phase 12 {e.name} {label}, frame {f} of {frames}: kernel "
              f"vs plain " + ", ".join(parts), flush=True)
        check(ok, f"{e.name} {label} disagrees after frame {f}")
    return worst, got[-1]


def soft_substep_case(tt, e, mesh, arr):
    """One substep at full width from rest through the frame kernel vs its
    plain twin, beside its own spread from positions 1 ulp apart.  With the
    engine's parameters the collapsing blob is chaotic within one sweep
    (PERF.md), so that substep is held only to twice its spread.  With the
    deviatoric compliance 10x higher, a softer material on the same tables,
    it is held to 2e-5 or twice its spread, whichever is larger, and must
    move the sweep's planes by ten times that bound or more (the predicted
    planes, against the swept ones of the plain twin), so that a kernel
    that did nothing would fail.  Returns that difference."""
    from tetsim_torch.kernels.polar_pieces import predict_planes

    base = tt.PhysicsParams(num_substeps=PIECES_SUBSTEPS)
    params = dataclasses.replace(
        base, num_substeps=1, time_step=base.time_step / PIECES_SUBSTEPS)
    state = tt.init_state(mesh, "cuda")
    pack, kstep, _, _ = e.make(arr)
    _, pstep, _, _ = e.twin(arr)
    none = tt.Controls.none("cuda")
    soft = dataclasses.replace(params,
                               dev_compliance=10 * params.dev_compliance)
    for p, label, floor in ((params, "the engine's parameters", 0.0),
                            (soft, "dev_compliance x10", 2e-5)):
        packed = pack(state, p)
        moved = pack(state.replace(pos=torch.nextafter(
            state.pos, torch.full_like(state.pos, 10.0))), p)
        got, want, spread = (kstep(packed, p, none), pstep(packed, p, none),
                             kstep(moved, p, none))
        pred = predict_planes(*packed[:6], arr.movw_l > 0.0, p.dt, p)[:3]
        sync()
        d = max(max_diff(k, r) for k, r in zip(got[:3], want[:3]))
        s = max(max_diff(k, m) for k, m in zip(got[:3], spread[:3]))
        shift = max(max_diff(w, q) for w, q in zip(want[:3], pred))
        t = max(floor, 2 * s)
        print(f"phase 12 {e.name} one substep at {mesh.num_tets} tets "
              f"({arr.B} pieces, banded) from rest, {label}: kernel vs plain "
              f"max|dpos| {d:.3e} (tol {t:.3e}, 1-ulp spread {s:.3e}); the "
              f"sweep moves the planes by up to {shift:.3e}", flush=True)
        check(d <= t, f"{e.name} one substep at full width disagrees, {label}")
    check(shift >= 10 * t, f"{e.name} one substep moves too little to hold")
    return d


def seeded_state(tt, mesh, vel, seed):
    state = tt.init_state(mesh, "cuda")
    rng = np.random.RandomState(seed)
    v = rng.uniform(-vel, vel, (mesh.num_particles, 3)).astype(np.float32)
    return state.replace(vel=torch.tensor(v, device="cuda"))


def pieces_vs_plain(tt, e, big_mesh, big_arr):
    """Phase 12 for one engine; returns the largest position difference of
    the cases held strictly."""
    params = tt.PhysicsParams(num_substeps=PIECES_SUBSTEPS)
    none = tt.Controls.none("cuda")
    errs = []
    mesh = tt.ellipsoid_mesh(**BLOB_SMALL)
    pins = np.argsort(-mesh.verts[:, 1])[:2].tolist()
    grab = int(np.argmax(mesh.verts[:, 0]))
    target = torch.tensor(mesh.verts[grab] + np.float32([0.0, 0.05, 0.02]),
                          device="cuda")
    controls = tt.Controls(grab_id=torch.tensor(grab, dtype=torch.int32,
                                                device="cuda"),
                           grab_pos=target)
    for banded in (False, True):
        arr = e.build(mesh, tets_per_piece=512, pinned=pins,
                      boundary_prefix=banded, device="cuda")
        err, out = pieces_case(
            e, arr, seeded_state(tt, mesh, 0.3, 1), params, controls, 3,
            f"blob ({mesh.num_tets} tets, {arr.B} pieces"
            f"{', banded' if banded else ''}) 2 pinned, grab")
        pos = e.make(arr)[3](out)
        check(torch.equal(pos[pins], torch.tensor(mesh.verts[pins],
                                                  device="cuda")),
              "pinned particles moved")
        check(torch.equal(pos[grab], target), "grab off target")
        errs.append(err)

    # a blob resting on the ground after 60 frames, 1 frame
    arr = e.build(mesh, tets_per_piece=512, boundary_prefix=True,
                  device="cuda")
    pack, step, unpack, unpack_pos = e.make(arr)
    packed = pack(tt.init_state(mesh, "cuda"), params)
    for _ in range(60):
        packed = step(packed, params, none)
    err, out = pieces_case(e, arr, unpack(packed, params), params, none, 1,
                           "blob resting on the ground")
    ground = int((unpack_pos(out)[:, 1] == 0).sum())
    print(f"phase 12 resting: {ground} particles on the ground", flush=True)
    check(ground > 0, "the resting blob does not touch the ground")
    errs.append(err)

    # blobs past the walls at friction k = dt * friction = 0.1: one 2 mm
    # past +x moving at +1 m/s, one 2 mm past -z and below the ground moving
    # at -1 m/s in z
    slip = dataclasses.replace(params, friction=0.1 / float(params.dt))
    lo, hi = params.world_min, params.world_max
    v = mesh.verts
    for shift, axis, speed, label in (
            ([hi[0] + 0.002 - v[:, 0].max(), 0.0, 0.0], 0, 1.0, "+x"),
            ([0.0, -0.002 - v[:, 1].min(), lo[2] - 0.002 - v[:, 2].min()], 2,
             -1.0, "-z and the ground")):
        state = tt.init_state(mesh, "cuda")
        state.pos += torch.tensor(shift, dtype=torch.float32, device="cuda")
        state.vel[:, axis] = speed
        err, out = pieces_case(e, arr, state, slip, none, 2,
                               f"blob past {label}, friction k=0.100")
        pos = unpack_pos(out)
        wall = float(hi[0]) if axis == 0 else float(lo[2])
        at = int((pos[:, axis] == wall).sum())
        print(f"phase 12 walls: {at} particles at the {label.split()[0]} wall, "
              f"{int((pos[:, 1] == 0).sum())} on the ground", flush=True)
        check(at > 0, "the wall was not reached")
        errs.append(err)

    mid = tt.ellipsoid_mesh(**BLOB_MID)
    arr = e.build(mid, tets_per_piece=PIECES_TPP, boundary_prefix=True,
                  device="cuda")
    errs.append(pieces_case(
        e, arr, seeded_state(tt, mid, 0.1, 2), params, none, 2,
        f"blob at cell 0.05 ({mid.num_tets} tets, {arr.B} pieces, banded)")[0])
    # the full-width blob at cell 0.02, from rest.  Where the engine
    # collapses its tets there, a 1-ulp change moves a frame by tenths, so
    # whole frames are held only by their spread and one sweep at that width
    # is held strictly in their place
    err = pieces_case(
        e, big_arr, tt.init_state(big_mesh, "cuda"), params, none, 2,
        f"blob at cell 0.02 ({big_mesh.num_tets} tets, {big_arr.B} pieces, "
        "banded), from rest")[0]
    errs.append(soft_substep_case(tt, e, big_mesh, big_arr) if e.collapses
                else err)
    return max(errs)


def pieces_refusal(tt, e):
    """A piece over one block's shared memory (the 62,370-tet blob at 8,192
    tets per piece) is refused with polar_pieces' ValueError, before any
    launch."""
    mid = tt.ellipsoid_mesh(**BLOB_MID)
    arr = e.build(mid, tets_per_piece=8192, device="cuda")
    params = tt.PhysicsParams(num_substeps=PIECES_SUBSTEPS)
    pack, step, _, _ = e.make(arr)
    packed = pack(tt.init_state(mid, "cuda"), params)
    before = e.mod.launch_count
    try:
        step(packed, params, tt.Controls.none("cuda"))
    except ValueError as err:
        print(f"phase 12 {e.name} shared-memory refusal (rp {arr.rp}, rt "
              f"{arr.rt}: {e.mod.smem_bytes(arr.rp, arr.rt)} bytes): {err}",
              flush=True)
    else:
        raise AssertionError("a piece over the shared memory was accepted")
    check(e.mod.launch_count == before, "the refused piece launched")


def full_width_pieces(tt, engines):
    """bench.py's 987,090-tet blob with its boundary surface, and each
    engine's banded schedule at 2,048 tets per piece, built once and shared
    by phases 12-14."""
    t0 = time.perf_counter()
    blob = tt.with_boundary_surface(tt.ellipsoid_mesh(**BLOB))
    print(f"phase 12 blob: {blob.num_particles} particles, {blob.num_tets} "
          f"tets, {blob.num_surface_verts} surface vertices; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    big = {}
    for e in engines:
        t0 = time.perf_counter()
        a = big[e.name] = e.build(blob, tets_per_piece=PIECES_TPP,
                                  boundary_prefix=True, device="cuda")
        print(f"phase 12 {e.name} schedule: {a.B} pieces, rp {a.rp} (J=2 "
              f"band {a.r2}, shared bands {a.rb}), {e.describe(a)}, "
              f"{len(a.tier_counts)} tiers; {time.perf_counter() - t0:.2f} s",
              flush=True)
    return blob, big


def pieces_main_path(tt, e, mesh, arr, kernels):
    """Phase 13 for one engine at full width: World/Body with a grab, the
    surface and diagnostics, then the packed stepper; returns the kernel's
    launches."""
    mod, name = e.mod, e.name
    params = tt.PhysicsParams(num_substeps=PIECES_SUBSTEPS)
    frames = (10, 10)
    want = sum(frames) * e.per_frame
    target = np.float32([0.0, 1.6, 0.0])
    launches = 0

    def checked(label, pos, pid, t0):
        count = mod.launch_count
        check(count == want, f"{label}: {count} launches, expected {want}")
        others = {k: m.launch_count for k, m in kernels.items()
                  if m is not mod and m.launch_count}
        check(not others, f"{label} launched {others}")
        check(np.isfinite(pos).all(), f"{label} positions not finite")
        check(pos[:, 1].min() >= -1e-5, f"{label} below the ground")
        check(np.array_equal(pos[pid], target), f"{label} grab off target")
        print(f"phase 13 {label}: {sum(frames)} frames at {PIECES_SUBSTEPS} "
              f"substeps, {count} launches, grab pid {pid} at target, min y "
              f"{pos[:, 1].min():.4f}; {time.perf_counter() - t0:.2f} s",
              flush=True)
        return count

    for m in kernels.values():
        m.launch_count = 0
    t0 = time.perf_counter()
    world = tt.World(params)
    body = world.add_body(mesh, engine=name, arrays=arr)
    with no_host_sync():
        world.step(frames[0])
    pid = body.start_grab([0.0, 1.5, 0.0])
    body.move_grabbed(target)
    with no_host_sync():
        world.step(frames[1])
    pos = body.positions
    verts, normals, tris = body.surface_mesh()
    diag = world.diagnostics()["body0"]
    check(verts.shape == (mesh.num_surface_verts, 3) and np.isfinite(verts).all(),
          f"{name} surface")
    check(np.abs(np.linalg.norm(normals, axis=1) - 1.0).max() < 1e-4,
          f"{name} normals")
    check(not diag["nan"] and "volume_error" not in diag, f"diagnostics {diag}")
    launches += checked(f"World/Body(engine={name!r})", pos, pid, t0)
    print(f"phase 13 {name} surface {verts.shape[0]} vertices, {tris.shape[0]} "
          f"triangles, unit normals; diagnostics {diag}", flush=True)

    for m in kernels.values():
        m.launch_count = 0
    t0 = time.perf_counter()
    pack, step, unpack, unpack_pos = e.make(arr)
    packed = pack(tt.init_state(mesh, "cuda"), params)
    free = tt.Controls.none("cuda")
    grabbed = tt.Controls(
        grab_id=torch.tensor(pid, dtype=torch.int32, device="cuda"),
        grab_pos=torch.tensor(target, device="cuda"))
    with no_host_sync():
        for f in range(sum(frames)):
            packed = step(packed, params, grabbed if f >= frames[0] else free)
    pos = unpack_pos(packed).cpu().numpy()
    check(np.isfinite(unpack(packed, params).vel.cpu().numpy()).all(),
          f"{name} packed velocities")
    launches += checked(f"{name} packed stepper", pos, pid, t0)
    return launches


def event_ms(fn, n):
    """CUDA-event time per call over ``n`` calls, after one warm-up.  A spin
    kernel ahead of them keeps the card busy while the host enqueues the
    calls, so the span is their device time and not the host's pace (the
    NH wrapper takes longer to enqueue a launch than the kernel runs)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync()
    torch.cuda._sleep(100_000_000)  # about 50 ms at 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def pieces_timings(tt, e, mesh, arr, label):
    """Phase 14: (kernel ms and plain ms per substep, bound).  The kernel
    (K6's solve, K5's whole frame) is timed on the state after the fit's 28
    frames from rest: for the Neo-Hookean engine a collapsed blob, as on
    its main path."""
    params = tt.PhysicsParams(num_substeps=PIECES_SUBSTEPS)
    pack, step, _, _ = e.make(arr)
    st = {"p": pack(tt.init_state(mesh, "cuda"), params)}
    none = tt.Controls.none("cuda")

    def frames(k):
        for _ in range(k):
            st["p"] = step(st["p"], params, none)

    sub_ms = per_frame(frames, lambda: st["p"][0].sum(), 4, 24) * 1e3 \
        / PIECES_SUBSTEPS
    kernel, plain, per_call = e.timed(arr, st["p"], params)
    k_ms = event_ms(kernel, 50) / per_call
    p_ms = event_ms(plain, 5) / per_call
    one = dataclasses.replace(params, num_substeps=1)
    b = bound(e.mod.frame_flops(arr, one), e.mod.frame_bytes(arr, one))
    design = ""  # K5: the bytes its design moves beyond the function's
    if hasattr(e.mod, "design_bytes"):
        d = bound(0, e.mod.frame_bytes(arr, one)
                  + e.mod.design_bytes(arr, one))[0]
        design = f", {d * 1e3:.3f} us at the design's own bytes"
    print(f"phase 14 [{label}] {e.name} at {mesh.num_tets} tets: substep "
          f"{sub_ms:.4f} ms ({1e3 / sub_ms:.1f} substeps/s), of it the kernel "
          f"{k_ms:.4f} ms (CUDA events over calls of {per_call} substeps; "
          f"{b[0] * 1e3:.3f} us bound by {b[1]}{design}) and the rest (torch ops "
          f"and the host's pace) {sub_ms - k_ms:.4f} ms "
          f"({(sub_ms - k_ms) / sub_ms:.1%}); plain twin {p_ms:.4f} ms",
          flush=True)
    return k_ms, p_ms, b


# -- the exact-order kernel (K7), the viewer and extract_rotation (K9) ---------

def ordered_case(go, body, params, frames, label):
    """K7 vs its plain twin from ``body``'s state, after each of ``frames``
    frames, beside K7's own spread: the largest difference between K7 from
    the state and K7 from positions 1 ulp above it, 1 ulp below it, or
    velocities 1 ulp above.  Positions are held to 2e-5 and velocities to
    2e-3, or to twice K7's spread where that is larger: the dragon's exact
    order amplifies a 1-ulp change (in free fall to 6.5e-5 in 3 frames,
    PERF.md), and K7 contracts multiply-adds into FMAs where the twin
    rounds each product.  Returns (the largest position difference, the
    twin's seconds per frame)."""
    args = (body.tables, params, body.grab_id, body.grab_pos)

    def run(frame, p, v=body.vel):
        out = []
        for _ in range(frames):
            p, _, v = frame(p, v, *args)
            out.append((p, v))
        sync()
        return out

    got = run(go.ordered_frame, body.pos)
    t0 = time.perf_counter()
    want = run(go.ordered_frame_reference, body.pos)
    plain_s = (time.perf_counter() - t0) / frames

    def ulp(x, to):
        return torch.nextafter(x, torch.full_like(x, to))

    moved = [run(go.ordered_frame, ulp(body.pos, 10.0)),
             run(go.ordered_frame, ulp(body.pos, -10.0)),
             run(go.ordered_frame, body.pos, ulp(body.vel, 10.0))]
    worst = 0.0
    for f, (k, r, *m) in enumerate(zip(got, want, *moved), 1):
        dp, dv = max_diff(k[0], r[0]), max_diff(k[1], r[1])
        sp = max(max_diff(k[0], x[0]) for x in m)
        sv = max(max_diff(k[1], x[1]) for x in m)
        ptol, vtol = max(2e-5, 2 * sp), max(2e-3, 2 * sv)
        print(f"phase 15 {label}, frame {f} of {frames}: K7 vs plain "
              f"max|dpos| {dp:.3e} (tol {ptol:.3e}) max|dvel| {dv:.3e} (tol "
              f"{vtol:.3e}); K7 vs K7 from 1 ulp apart: pos {sp:.3e}, vel "
              f"{sv:.3e}", flush=True)
        check(dp <= ptol and dv <= vtol, f"K7 {label} disagrees after frame {f}")
        worst = max(worst, dp)
    body.pos, body.vel = got[-1]
    return worst, plain_s


def ordered_vs_plain(tt, go, gs_fused, dragon):
    """Phase 15: returns (largest position difference, the twin's ms per
    frame of 8 dragons)."""
    params = tt.default_cpu_params()
    body = go.OrderedGSBody(dragon, jitter=0.5, pinned=[0])
    start = body.pos
    body.set_grab(2, 100, start[2, 100].cpu().numpy() + np.float32([0, 0.05, 0]))
    tables = body.tables
    arr = tt.build_arrays(dragon, coloring="ordered", pinned=[0], device="cuda")
    k1, _, k1v, _ = gs_fused.gs_frame(start, body.vel, arr, params,
                                       body.grab_id, body.grab_pos)
    k7, _, k7v = go.ordered_frame(start, body.vel, tables, params,
                                  body.grab_id, body.grab_pos)
    d17, d17v = max_diff(k7, k1), max_diff(k7v, k1v)
    print(f"phase 15 K7 vs K1 on the ordered schedule, B=8, 1 frame: "
          f"max|dpos| {d17:.3e} max|dvel| {d17v:.3e} (the predict and "
          "velocity rounding; tol 2e-5)", flush=True)
    check(d17 <= 2e-5, "K7 and K1 on one schedule disagree")
    err, plain_s = ordered_case(go, body, params, 3, "B=8 jittered, a pinned "
                                "particle, a grab on body 2")
    check(torch.equal(body.pos[:, 0], start[:, 0]), "pinned particle moved")
    check(torch.equal(body.pos[2, 100], body.grab_pos[2, 0]), "grab off target")

    rest = go.OrderedGSBody(dragon, jitter=0.5)
    rest.step(params, 120)
    errs = [err, ordered_case(go, rest, params, 1,
                              "B=8 resting on the ground")[0]]
    grounded = int((rest.pos[..., 1] == 0).any(dim=1).sum())
    print(f"phase 15 resting: {grounded} of 8 bodies on the ground", flush=True)
    check(grounded == 8, "a resting dragon does not touch the ground")

    # body 0 2 mm past +x moving at +1 m/s, body 1 2 mm past -z and below
    # the ground moving at -1 m/s in z, friction k = dt * 30 = 0.1
    slip = dataclasses.replace(params, friction=30.0)
    lo, hi = params.world_min, params.world_max
    v = dragon.verts
    wall = go.OrderedGSBody(dragon)
    shift = torch.zeros((8, 1, 3), device="cuda")
    shift[0, 0, 0] = float(hi[0] + 0.002 - v[:, 0].max())
    shift[1, 0, 1] = float(-0.002 - v[:, 1].min())
    shift[1, 0, 2] = float(lo[2] - 0.002 - v[:, 2].min())
    wall.pos = wall.pos + shift
    wall.vel[0, :, 0] = 1.0
    wall.vel[1, :, 2] = -1.0
    errs.append(ordered_case(go, wall, slip, 2, "two dragons past the walls, "
                             "friction k=0.1")[0])
    at_x = int((wall.pos[0, :, 0] == float(hi[0])).sum())
    at_z = int((wall.pos[1, :, 2] == float(lo[2])).sum())
    ground = int((wall.pos[1, :, 1] == 0).sum())
    print(f"phase 15 walls: {at_x} particles at +x, {at_z} at -z, {ground} on "
          "the ground", flush=True)
    check(at_x > 0 and at_z > 0 and ground > 0, "the walls were not reached")
    return max(errs), plain_s * 1e3


def ordered_main_path(tt, go, gs_fused, dragon):
    """Phase 16: World -> add_body_batch(..., backend="fused_ordered") for
    150 frames, a grab, diagnostics, then save -> World.load and one more
    frame in each world.  Returns (launches, K7 ms per frame)."""
    from tetsim_torch._compile import BUILD_DIR

    params = tt.default_cpu_params()
    lo, hi = params.world_min - 1e-5, params.world_max + 1e-5
    target = np.float32([0.0, 1.5, 0.5])
    go.launch_count = gs_fused.launch_count = 0
    world = tt.World(tt.default_cpu_params())
    batch = world.add_body_batch(dragon, 8, engine="neohookean",
                                 backend="fused_ordered", jitter=0.5)
    check(type(batch) is go.OrderedGSBody, "fused_ordered is not OrderedGSBody")
    with no_host_sync():
        world.step(120)
    pid = batch.start_grab(3, [0.0, 1.0, 0.5])
    batch.move_grabbed(3, target)
    with no_host_sync():
        world.step(30)
    launches = go.launch_count
    pos = batch.positions()
    diag = world.diagnostics()["body0"]
    check(launches == 150, f"{launches} K7 launches for 150 frames")
    check(gs_fused.launch_count == 0, "the exact-order batch ran gs_frame")
    check(np.isfinite(pos).all() and pos.shape == (8, 1234, 3), "positions")
    check(pos[..., 1].min() >= -1e-5, "below the ground")
    check(((pos >= lo) & (pos <= hi)).all(), "outside the world bounds")
    check(np.abs(pos[3, pid] - target).max() <= 1e-6, "grab off target")
    check(not diag["nan"] and diag["batch"] == 8
          and all(np.isfinite(x) for x in diag.values()),
          f"diagnostics {diag}")
    print(f"phase 16 add_body_batch(dragon, 8, backend='fused_ordered'): 150 "
          f"frames, {launches} launches, grab pid {pid} of body 3 at target, "
          f"diagnostics {diag}", flush=True)

    path = f"{BUILD_DIR}/phase16_scene.npz"  # inside the checkout, ignored
    world.save(path)
    loaded = tt.World.load(path, device="cuda")
    check(loaded.device.type == "cuda", "World.load is not on the card")
    world.step(1)
    loaded.step(1)
    a, b = world.bodies[0], loaded.bodies[0]
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("pos", "prev_pos", "vel", "grab_id", "grab_pos"))
    print(f"phase 16 save -> World.load(device='cuda'), one more frame in each: "
          f"bitwise equal {same}", flush=True)
    check(same, "the loaded world steps differently")
    k_ms = event_ms(lambda: batch.step(params), 50)
    levels = batch.tables.sub_ids.shape[0]
    print(f"phase 16 K7 {k_ms:.4f} ms per frame of 8 dragons: "
          f"{k_ms * 1e3 / (levels * params.num_substeps):.4f} us per "
          f"sub-level ({levels} per substep, a lane per tet)", flush=True)
    return launches, k_ms


def viewer_on_card(tt, go, polar_fused, dragon):
    """Phase 17: a ViewerServer over a polar dragon Body (20 substeps, K2)
    and the fused_ordered batch (K7), driven over HTTP for about 5 s."""
    import urllib.request

    from tetsim_torch.viewer import ViewerServer

    def get(path):
        with urllib.request.urlopen(f"{url}{path}", timeout=120) as r:
            return r.read()

    def post(path, obj):
        req = urllib.request.Request(f"{url}{path}", method="POST",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def header(blob):
        return json.loads(blob[:blob.index(b"\n")])

    world = tt.World(tt.default_gpu_params())
    body = world.add_body(dragon, engine="polar")
    batch = world.add_body_batch(dragon, 8, engine="neohookean",
                                 backend="fused_ordered", jitter=0.5)
    # apart in z (the dragon spans 1 m in z, 2.2 m in x), so a ray along x
    # through the polar dragon passes the batch 1.6 m away or more
    body.state = body.state.replace(
        pos=body.state.pos + torch.tensor([0.0, 0.0, -1.5], device="cuda"))
    batch.pos = batch.pos + torch.tensor([0.0, 0.0, 1.2], device="cuda")
    go.launch_count = polar_fused.launch_count = 0
    srv = ViewerServer(world, port=0).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        t0 = time.perf_counter()
        mesh = header(get("/mesh"))
        check(mesh["n_vis"] == 29800 * 9 and mesh["n_particles"] == 1234 * 9,
              f"/mesh header {mesh}")
        time.sleep(0.5)
        h1, t1 = header(get("/state")), time.perf_counter()
        time.sleep(0.5)
        blob = get("/state")
        h2 = header(blob)
        check(h2["frame"] > h1["frame"], "the sim thread does not advance")
        check(len(blob) - blob.index(b"\n") - 1
              == 4 * 3 * (2 * mesh["n_vis"] + mesh["n_particles"]),
              "/state payload size")
        # a grab on the polar dragon: a ray along -x through its centroid,
        # then dragged up
        with srv._lock:
            c = body.state.pos.mean(dim=0).cpu().numpy()
        origin, d = c + np.float32([3.0, 0.0, 0.0]), [-1.0, 0.0, 0.0]
        gid = post("/grab", {"action": "start", "origin": origin.tolist(),
                             "dir": d})["grabbed"]
        check(0 <= gid < 1234, f"grab on the polar dragon gave {gid}")
        post("/grab", {"action": "move", "dir": d,
                       "origin": (origin + np.float32([0, 0.3, 0])).tolist()})
        time.sleep(0.5)
        with srv._lock:
            held = max_diff(body.state.pos[gid], body.controls.grab_pos)
        check(held <= 1e-6, f"the grabbed polar particle is {held} off target")
        # a grab on the batch: a ray straight down onto body 5's particle
        # 300 (the bodies move and overlap: the owner comes from the id)
        with srv._lock:
            p = batch.pos[5, 300].cpu().numpy()
        flat = post("/grab", {"action": "start", "dir": [0.0, -1.0, 0.0],
                              "origin": (p + np.float32([0, 3, 0])).tolist()}
                    )["grabbed"] - 1234
        owner, local = flat // 1234, flat % 1234
        check(0 <= owner < 8, f"the ray onto the batch grabbed {flat + 1234}")
        check(int(batch.grab_id[owner, 0]) == local,
              "the batch grab is not in its body's slot")
        check(int(body.controls.grab_id) == -1, "the first grab leaked")
        post("/grab", {"action": "move", "dir": [0.0, -1.0, 0.0],
                       "origin": (p + np.float32([0.2, 3.3, 0])).tolist()})
        time.sleep(0.5)
        with srv._lock:
            held = max_diff(batch.pos[owner, local], batch.grab_pos[owner, 0])
        check(held <= 1e-6, f"the grabbed batch particle is {held} off target")
        post("/grab", {"action": "end"})
        check(int(batch.grab_id[owner, 0]) == -1, "the batch grab did not end")
        post("/params", {"normals": "rotated"})
        time.sleep(0.3)
        blob = get("/state")
        check(header(blob)["normals"] == "rotated", "rotated normals not set")
        nv = mesh["n_vis"]
        nrm = np.frombuffer(blob[blob.index(b"\n") + 1:], "<f4")[
            3 * nv:6 * nv].reshape(-1, 3)
        check(np.isfinite(nrm).all(), "rotated normals not finite")
        post("/reset", {})
        time.sleep(0.3)
        diag = json.loads(get("/diag"))
        check(all(not v["nan"] for v in diag.values()), f"/diag {diag}")
        time.sleep(max(0.0, 5.0 - (time.perf_counter() - t0)))
        h3, t3 = header(get("/state")), time.perf_counter()
        seconds = t3 - t0
        check(srv.sim_error is None, f"sim error: {srv.sim_error}")
        check(go.launch_count > 0 and polar_fused.launch_count > 0,
              f"launches K7 {go.launch_count}, K2 {polar_fused.launch_count}")
        fps = (h3["frame"] - h1["frame"]) / (t3 - t1)
        print(f"phase 17 viewer: /mesh {mesh['n_vis']} vertices, "
              f"{mesh['n_tris']} triangles; grabs on polar particle {gid} and "
              f"batch body {owner} particle {local} held their targets; "
              f"rotated normals, reset, "
              f"/diag; sim error {srv.sim_error}; {h3['frame']} frames in "
              f"{seconds:.2f} s ({fps:.1f} frames/s, step_ms "
              f"{h3['step_ms']}); launches K7 {go.launch_count}, K2 "
              f"{polar_fused.launch_count}", flush=True)
        post("/shutdown", {})
        srv._sim_thread.join(timeout=30)
        check(not srv._sim_thread.is_alive(), "/shutdown left the sim running")
    finally:
        srv.stop()


def extract_rotation_vs_plain(roofline):
    """Phase 18: K9 vs its twin on 1,048,576 lanes at k = 4, then ms per
    9-iteration pass (two-point fit over 4 and 16 passes), the twin's ms and
    the measured copy rate.  Returns (difference, launches, ms, plain ms,
    GB/s)."""
    a = roofline.random_planes()
    q = roofline.extract_rotation(a, 4)
    want = roofline.extract_rotation_reference(a, 4)
    moved = roofline.extract_rotation(
        torch.nextafter(a, torch.full_like(a, 10.0)), 4)
    dq, sq = max_diff(q, want), max_diff(q, moved)
    tol = max(2e-5, 2 * sq)
    print(f"phase 18 extract_rotation {a[0].numel()} lanes, 4 passes: K9 vs "
          f"plain max|dquat| {dq:.3e} (tol {tol:.3e}); K9 vs K9 from 1 ulp "
          f"apart {sq:.3e}", flush=True)
    check(dq <= tol, "K9 disagrees")
    roofline.launch_count = 0
    k_ms = roofline.bench_extract_rotation_kernel(a)
    launches = roofline.launch_count
    p_ms = roofline.bench_extract_rotation_plain(a)
    gbps = roofline.bench_hbm_copy()
    print(f"phase 18 K9 {k_ms:.4f} ms per 9-iteration pass ({launches} "
          f"launches), plain twin {p_ms:.3f} ms ({p_ms / k_ms:.1f}x); copy "
          f"y = x * c over 256 MB {gbps:.1f} GB/s", flush=True)
    return dq, launches, k_ms, p_ms, gbps


# -- the large bodies (gs_levels, polar_jacobi) and the flat NH batch ----------

LARGE = (20, 20, 20)  # 9,261 particles, 48,000 tets: over one block's 6,456
LARGE_BOX = dict(cell=0.05, origin=(-0.5, 0.3, -0.5))
LARGE_FRAMES = 5


def hold(label, rows):
    """Each row (name, kernel, reference, tol, spread): the kernel against
    the reference within tol, or within twice ``spread`` (a kernel's own
    difference from a start 1 ulp apart) where that is given and larger.
    Returns the position difference."""
    parts, ok, dpos = [], True, 0.0
    for name, k, r, tol, spread in rows:
        d = max_diff(k, r)
        t = tol if spread is None else max(tol, 2 * spread)
        ok = ok and d <= t
        if name == "pos":
            dpos = d
        parts.append(f"{name} {d:.3e} (tol {t:.3e}"
                     + ("" if spread is None else f", spread {spread:.3e}")
                     + ")")
    print(f"{label}: kernel vs plain " + ", ".join(parts), flush=True)
    check(ok, f"{label} disagrees")
    return dpos


def large_bodies(tt, kernels):
    """Phase 19: World().add_body(grid_mesh(20, 20, 20), engine=...) on the
    card for both engines, 5 frames with a grab holding a corner 2 cm up;
    after every frame the body is held to the twin run from the same start
    (and beside the kernel from positions 1 ulp apart); the multi-block
    kernel's launch counter counts the frames, K1's and K2's stay 0.
    Returns {module: (launches, largest position difference)}."""
    from tetsim_torch.kernels import gs_levels, polar_jacobi

    mesh = tt.grid_mesh(*LARGE, **LARGE_BOX)
    target = torch.tensor(np.float32(mesh.verts[0] + [0.0, 0.02, 0.0]),
                          device="cuda")
    out = {}
    for engine, mod in (("neohookean", gs_levels), ("polar", polar_jacobi)):
        polar = engine == "polar"
        bodies = []
        for shift in (False, True):
            world = tt.World()
            body = world.add_body(mesh, engine=engine)
            check(body.kernel is mod, f"{engine}: Body runs {body.kernel}")
            if shift:
                body.state = body.state.replace(pos=torch.nextafter(
                    body.state.pos, torch.full_like(body.state.pos, 10.0)))
            body.controls = tt.Controls(
                grab_id=torch.tensor(0, dtype=torch.int32, device="cuda"),
                grab_pos=target)
            bodies.append((world, body))
        (world, body), (world1, body1) = bodies
        params = world.params
        gid, gpos = target.new_zeros((1, 1), dtype=torch.int32), target[None, None]
        s = body.state
        twin = [s.pos[None], s.vel[None]] + ([s.quats[None]] if polar else [])
        for m in kernels.values():
            m.launch_count = 0
        t0 = time.perf_counter()
        worst = 0.0
        for f in range(1, LARGE_FRAMES + 1):
            with no_host_sync():
                world.step(1)
                world1.step(1)
            if polar:
                r = mod.jacobi_frame_reference(*twin, body.arrays, params, gid,
                                               gpos)
                twin = [r[0], r[2], r[3]]
                extra = [("quat", body.state.quats, r[3][0], 2e-5,
                          max_diff(body.state.quats, body1.state.quats))]
                vtol = 2e-2
            else:
                r = mod.levels_frame_reference(*twin, body.arrays, params,
                                               gid, gpos)
                twin = [r[0], r[2]]
                extra = [("vol_err", body.last_diag, r[3][0], 1e-5, None)]
                vtol = 2e-3
            worst = max(worst, hold(
                f"phase 19 {engine} Body {LARGE} ({mesh.num_tets} tets) "
                f"frame {f}", [
                    ("pos", body.state.pos, r[0][0], 2e-5, None),
                    ("vel", body.state.vel, r[2][0], vtol, None)] + extra))
        seconds = time.perf_counter() - t0
        want = 2 * LARGE_FRAMES * mod.LAUNCHES_PER_FRAME
        others = {k: m.launch_count for k, m in kernels.items()
                  if m is not mod and m.launch_count}
        check(mod.launch_count == want and not others,
              f"{engine}: {mod.launch_count} launches (expected {want}), "
              f"others {others}")
        check(max_diff(body.state.pos[0], target) == 0.0, "grab off target")
        diag = world.diagnostics()["body0"]
        check(not diag["nan"], f"{engine} diagnostics {diag}")
        print(f"phase 19 {engine}: {mod.__name__.split('.')[-1]} "
              f"{mod.launch_count} launches for 2 bodies x {LARGE_FRAMES} "
              f"frames, K1 and K2 none; min y {diag['min_height']:.4f}; "
              f"{seconds:.2f} s", flush=True)
        out[mod] = (mod.launch_count // 2, worst)
    return out


def levels_batches(tt, gs_levels):
    """Phase 19, gs_levels beyond one body: 8 jittered bodies of
    grid_mesh(20, 20, 20) with grabs on two of them through levels_frame (the
    cluster size the batch takes), and one body on clusters of one block
    (cs = 1, a level's virtual blocks in six passes), 2 frames each, held
    after every frame to the twin at phase 19's bars; cs = 1 is bitwise the
    body's own cluster size.  Returns the largest position difference."""
    mesh = tt.grid_mesh(*LARGE, **LARGE_BOX)
    arr = tt.build_arrays(mesh, coloring="ordered", device="cuda")
    params = tt.default_cpu_params()
    rng = np.random.RandomState(19)
    rest = np.float32(mesh.verts)
    pos = torch.tensor(rest + rng.normal(0, 0.002, (8,) + rest.shape)
                       .astype(np.float32), device="cuda")
    vel = torch.tensor(rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32),
                       device="cuda")
    gid = torch.full((8, 1), -1, dtype=torch.int32, device="cuda")
    gid[2, 0], gid[5, 0] = 0, 9260
    gpos = pos[torch.arange(8), gid[:, 0].clamp(min=0).long()][:, None] \
        + torch.tensor([0.0, 0.02, 0.0], device="cuda")
    waves = gs_levels.active_clusters(pos.device)

    def own(b):  # the cluster size levels_frame picks for b bodies
        return gs_levels.cluster_size(b, gs_levels.MAX_CLUSTER, waves)

    worst = 0.0
    for label, b, cs in (("B=8", 8, None), ("B=1 cs=1", 1, 1)):
        kernel = [pos[:b], vel[:b]]
        twin = list(kernel)
        wide = list(kernel)
        for f in range(1, 3):
            got = gs_levels._levels_frame_cuda(*kernel, arr, params, gid[:b],
                                               gpos[:b], cs=cs)
            want = gs_levels.levels_frame_reference(*twin, arr, params,
                                                    gid[:b], gpos[:b])
            kernel, twin = [got[0], got[2]], [want[0], want[2]]
            worst = max(worst, hold(
                f"phase 19 gs_levels {label} (cs "
                f"{cs or own(b)}) {LARGE} frame {f}", [
                    ("pos", got[0], want[0], 2e-5, None),
                    ("vel", got[2], want[2], 2e-3, None),
                    ("vol_err", got[3], want[3], 1e-5, None)]))
            if cs is not None:
                ref = gs_levels.levels_frame(*wide, arr, params, gid[:b],
                                             gpos[:b])
                wide = [ref[0], ref[2]]
                check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                      f"gs_levels at cs=1 is not its cs={own(b)} after "
                      f"frame {f}")
    print(f"phase 19 gs_levels: B=8 and cs=1 within the twin's bars, cs=1 "
          f"bitwise cs={own(1)}; clusters the card runs "
          f"at once {waves}", flush=True)
    return worst


def jacobi_batches(tt, polar_jacobi):
    """Phase 19, polar_jacobi beyond one body: 8 jittered polar bodies of
    grid_mesh(20, 20, 20) with grabs on two of them through jacobi_frame, 2
    frames, held after every frame to the twin at phase 19's bars (the
    quaternions also at twice the kernel's spread from positions 1 ulp
    apart), one launch per frame.  Returns the largest position
    difference."""
    mesh = tt.grid_mesh(*LARGE, **LARGE_BOX)
    arr = tt.build_arrays(mesh, coloring=None, device="cuda")
    params = tt.World().params
    rng = np.random.RandomState(29)
    rest = np.float32(mesh.verts)
    pos = torch.tensor(rest + rng.normal(0, 0.002, (8,) + rest.shape)
                       .astype(np.float32), device="cuda")
    vel = torch.tensor(rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32),
                       device="cuda")
    quats = torch.zeros((8, mesh.num_tets, 4), device="cuda")
    quats[..., 3] = 1.0
    gid = torch.full((8, 1), -1, dtype=torch.int32, device="cuda")
    gid[2, 0], gid[5, 0] = 0, mesh.num_particles - 1
    gpos = pos[torch.arange(8), gid[:, 0].clamp(min=0).long()][:, None] \
        + torch.tensor([0.0, 0.02, 0.0], device="cuda")
    kernel = [pos, vel, quats]
    moved = [torch.nextafter(pos, torch.full_like(pos, 10.0)), vel, quats]
    twin = list(kernel)
    polar_jacobi.launch_count = 0
    worst = 0.0
    for f in range(1, 3):
        got = polar_jacobi.jacobi_frame(*kernel, arr, params, gid, gpos)
        near = polar_jacobi.jacobi_frame(*moved, arr, params, gid, gpos)
        want = polar_jacobi.jacobi_frame_reference(*twin, arr, params, gid,
                                                   gpos)
        kernel, moved, twin = ([x[0], x[2], x[3]] for x in (got, near, want))
        worst = max(worst, hold(
            f"phase 19 polar_jacobi B=8 {LARGE} frame {f}", [
                ("pos", got[0], want[0], 2e-5, None),
                ("vel", got[2], want[2], 2e-2, None),
                ("quat", got[3], want[3], 2e-5, max_diff(got[3], near[3]))]))
    check(max_diff(kernel[0][[2, 5], gid[[2, 5], 0].long()], gpos[[2, 5], 0])
          == 0.0, "phase 19 polar_jacobi B=8: grabs off target")
    check(polar_jacobi.launch_count == 4 * polar_jacobi.LAUNCHES_PER_FRAME,
          f"polar_jacobi B=8: {polar_jacobi.launch_count} launches for 2 "
          "frames of two batches")
    grid = polar_jacobi.frame_grid(pos.device)
    print(f"phase 19 polar_jacobi: B=8 within the twin's bars, "
          f"{polar_jacobi.LAUNCHES_PER_FRAME} cooperative launch per frame "
          f"of {grid} blocks ({polar_jacobi.occupancy(pos.device)[0]} per "
          "SM)", flush=True)
    return worst


def flat_nh_batch(tt, gs_fused, dragon):
    """Phase 20: add_body_batch(dragon, 8, engine="neohookean",
    backend="flat") with a grab: bitwise FusedGSBody(coloring="ordered")
    from the same state for 2 frames, its first frame within 2e-5 of the
    plain twin in position (velocities 2e-2, K1's bar in phase 2); K1
    launches once per frame.  Returns (launches,
    difference)."""
    world = tt.World()
    flat = world.add_body_batch(dragon, 8, engine="neohookean",
                                backend="flat", jitter=0.3, seed=5)
    fused = gs_fused.FusedGSBody(dragon, 8, coloring="ordered", jitter=0.3,
                                 seed=5)
    check(torch.equal(flat.pos, fused.pos), "the batches start apart")
    target = (flat.pos[2, 30] + torch.tensor([0.0, 0.02, 0.0],
                                             device="cuda")).tolist()
    flat.set_grab(2, 30, target)
    fused.set_grab(2, 30, target)
    params = world.params
    start = (flat.pos, flat.vel)
    gs_fused.launch_count = 0
    with no_host_sync():
        world.step(1)
    launches = gs_fused.launch_count
    want = gs_fused.gs_frame_reference(*start, flat.arrays, params,
                                       flat.grab_id, flat.grab_pos)
    # K1 contracts its predict into FMAs, so its velocities are held as in
    # phase 2, 2e-2
    err = hold("phase 20 flat neohookean batch of 8 dragons, frame 1", [
        ("pos", flat.pos, want[0], 2e-5, None),
        ("vel", flat.vel, want[2], 2e-2, None)])
    before = gs_fused.launch_count
    with no_host_sync():
        world.step(1)
    launches += gs_fused.launch_count - before
    check(launches == 2, f"{launches} K1 launches for 2 frames")
    fused.step(params, 2)
    same = all(torch.equal(a, b) for a, b in (
        (flat.pos, fused.pos), (flat.vel, fused.vel),
        (flat.prev_pos, fused.prev_pos)))
    check(same, "the flat batch is not FusedGSBody(coloring='ordered')")
    check(torch.equal(flat.pos[2, 30], flat.grab_pos[2, 0]),
          "grab off target")
    print(f"phase 20 flat batch: {launches} K1 launches for 2 frames, "
          "bitwise equal to FusedGSBody(coloring='ordered') after 2 frames",
          flush=True)
    return launches, err


# -- the slab forms (K4a, K3s) ---------------------------------------------------


def slab_start(tt, polar, cell, origin):
    """(arrays, state, controls) of the 56^3 box with velocities seeded in
    +-0.1 and a grab lifting the top vertex of global plane x = 28 (a slab
    boundary at 2 and at 4 slabs) by 1 cm."""
    from tetsim_torch.solvers import neohookean_grid, polar_grid

    mesh = tt.grid_mesh(*GRID, cell=cell, origin=origin)
    build = (polar_grid.build_grid_arrays if polar
             else neohookean_grid.build_nh_grid_arrays)
    arr = build(mesh, GRID, device="cuda")
    rng = np.random.RandomState(6)
    st = tt.init_state(mesh, "cuda")
    st = st.replace(vel=torch.tensor(rng.uniform(-0.1, 0.1, st.vel.shape)
                                     .astype(np.float32), device="cuda"))
    g = GRID[1] + 1
    gid = (28 * g + g - 1) * g + 28
    ctl = tt.Controls(
        grab_id=torch.tensor(gid, dtype=torch.int32, device="cuda"),
        grab_pos=torch.tensor(np.float32(mesh.verts[gid] + [0.0, 0.01, 0.0]),
                              device="cuda"))
    return arr, st, ctl


def unsharded_frames(mod, arr, state, params, ctl, frames):
    """The unsharded kernel's states after each of ``frames`` frames."""
    pack, step, unpack, _ = mod.make_frame_stepper(arr)
    packed, out = pack(state, params), []
    for _ in range(frames):
        packed = step(packed, params, ctl)
        out.append(unpack(packed, params))
    return out


def polar_slabs(tt, polar_stencil):
    """Phase 21: the 56^3 box at cell 0.02 through make_grid_sharded_stepper
    on SlabMesh(4), SlabMesh(2) and SlabMesh(1), 3 frames from a seeded
    state with a grab on a slab boundary: two K4a launches per substep
    (pass A and the vertex pass; the card holds every slab); after every
    frame, positions and
    quaternions within 2e-5 or twice K4's 1-ulp spread of K4 unsharded,
    and the sharded twin at the polar bars.  Returns (K4a launches, largest
    difference from the twin)."""
    from tetsim_torch.parallel import SlabMesh
    from tetsim_torch.solvers import polar_grid

    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    arr, st, ctl = slab_start(tt, True, **GRID_BOX)
    ref = unsharded_frames(polar_stencil, arr, st, params, ctl, 3)
    moved = unsharded_frames(polar_stencil, arr, st.replace(
        pos=torch.nextafter(st.pos, torch.full_like(st.pos, 10.0))), params,
        ctl, 3)
    polar_stencil.acc_launch_count = 0
    launches, worst = 0, 0.0
    for d in (4, 2, 1):
        slabs = SlabMesh(d)
        prepare, step, unprepare = polar_stencil.make_grid_sharded_stepper(
            slabs, arr)
        twin = polar_grid.make_grid_sharded_step(slabs, arr)
        tslab, tarr = polar_grid.grid_prepare(st, arr, slabs)
        packed = prepare(st, params)
        for f in range(3):
            before = polar_stencil.acc_launch_count
            with no_host_sync():
                packed = step(packed, params, ctl)
            n = polar_stencil.acc_launch_count - before
            check(n == polar_stencil.SLAB_LAUNCHES_PER_SUBSTEP
                  * params.num_substeps,
                  f"K4a in {d} slabs: {n} launches for frame {f + 1}")
            launches += n
            got = unprepare(packed, params)
            tslab, _ = twin(tslab, tarr, params, ctl)
            tw = polar_grid.grid_unprepare(tslab, arr, d)
            k4, m4 = ref[f], moved[f]
            sp, sq = max_diff(k4.pos, m4.pos), max_diff(k4.quats, m4.quats)
            label = f"phase 21 K4a {GRID} in {d} slabs, frame {f + 1}"
            hold(label + " vs K4 unsharded", [
                ("pos", got.pos, k4.pos, 2e-5, sp),
                ("quat", got.quats, k4.quats, 2e-5, sq)])
            worst = max(worst, hold(label + " vs its sharded twin", [
                ("pos", got.pos, tw.pos, 2e-5, None),
                ("quat", got.quats, tw.quats, 2e-5, sq),
                ("vel", got.vel, tw.vel, 2e-2, None)]))
        check(max_diff(got.pos[ctl.grab_id.long()], ctl.grab_pos) == 0.0,
              "grab off target")
    check(launches > 0 and launches == polar_stencil.acc_launch_count,
          f"K4a launches {launches}")
    print(f"phase 21 K4a: {launches} launches for 3 frames at 4, 2 and 1 "
          f"slabs, {polar_stencil.SLAB_LAUNCHES_PER_SUBSTEP} per substep",
          flush=True)
    return launches, worst


def nh_slabs(tt, nh_stencil):
    """Phase 22: the 56^3 box at cell 0.05 (the Neo-Hookean engine collapses
    at 0.02) through make_nh_sharded_stepper on SlabMesh(4), SlabMesh(2) and
    SlabMesh(1), 3 frames each from a seeded state with a grab on a slab
    boundary: one K3s launch per frame, bit for bit K3 unsharded after every
    frame, and at 4 slabs within the Neo-Hookean bars of the sharded twin.
    Returns (K3s launches, largest difference from the twin)."""
    from tetsim_torch.parallel import SlabMesh
    from tetsim_torch.solvers import neohookean_grid

    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    arr, st, ctl = slab_start(tt, False, 0.05, (-1.4, 0.1, -1.4))
    ref = unsharded_frames(nh_stencil, arr, st, params, ctl, 3)
    nh_stencil.segment_launch_count = 0
    launches, worst = 0, 0.0
    for d in (4, 2, 1):
        slabs = SlabMesh(d)
        prepare, step, unprepare = nh_stencil.make_nh_sharded_stepper(slabs,
                                                                      arr)
        packed = prepare(st, params)
        if d == 4:
            twin = neohookean_grid.make_nh_sharded_step(slabs, arr)
            tslab = neohookean_grid.nh_prepare(st, arr, slabs)
        for f in range(3):
            before = nh_stencil.segment_launch_count
            with no_host_sync():
                packed = step(packed, params, ctl)
            n = nh_stencil.segment_launch_count - before
            check(n == nh_stencil.SLAB_LAUNCHES_PER_FRAME,
                  f"K3s in {d} slabs: {n} launches for frame {f + 1}")
            launches += n
            got = unprepare(packed, params)
            check(torch.equal(got.pos, ref[f].pos)
                  and torch.equal(got.vel, ref[f].vel),
                  f"K3s in {d} slabs is not K3 after frame {f + 1}: pos "
                  f"{max_diff(got.pos, ref[f].pos):.3e}")
            if d != 4:
                continue
            tslab, _ = twin(tslab, params, ctl)
            tw = neohookean_grid.nh_unprepare(tslab, arr, 4, params)
            worst = max(worst, hold(
                f"phase 22 K3s {GRID} in 4 slabs, frame {f + 1} (bitwise K3 "
                "unsharded) vs its sharded twin", [
                    ("pos", got.pos, tw.pos, 2e-5, None),
                    ("vel", got.vel, tw.vel, 2e-3, None)]))
        check(max_diff(got.pos[ctl.grab_id.long()], ctl.grab_pos) == 0.0,
              "grab off target")
    check(launches == nh_stencil.segment_launch_count,
          f"K3s launches {launches}")
    print(f"phase 22 K3s: {launches} launches for 3 frames at 4, 2 and 1 "
          "slabs, one per frame, every frame bit for bit K3 unsharded",
          flush=True)
    return launches, worst


def slab_timings(tt, polar_stencil, nh_stencil, label):
    """Phase 23: ms per substep at 56^3 of each slab form at 1, 2 and 4 slabs
    beside the unsharded kernel (two-point fits, data-dependent sync),
    launches per frame, and the sharded twins' ms at 4 slabs.  Returns
    {module: (ms at 4 slabs, twin ms, bound)}."""
    from tetsim_torch.parallel import SlabMesh
    from tetsim_torch.solvers import neohookean_grid, polar_grid

    params = tt.PhysicsParams(num_substeps=GRID_SUBSTEPS)
    one = dataclasses.replace(params, num_substeps=1)
    out = {}
    for mod, polar, box in ((polar_stencil, True, GRID_BOX),
                            (nh_stencil, False,
                             dict(cell=0.05, origin=(-1.4, 0.1, -1.4)))):
        arr, st, ctl = slab_start(tt, polar, **box)
        name = mod.__name__.split(".")[-1]
        make = (mod.make_grid_sharded_stepper if polar
                else mod.make_nh_sharded_stepper)
        counter = "acc_launch_count" if polar else "segment_launch_count"
        times = {}

        def fit(step, packed, pos_of):
            state = {"p": packed}

            def run(k):
                for _ in range(k):
                    state["p"] = step(state["p"], params, ctl)

            return per_frame(run, lambda: pos_of(state["p"]).sum(), 5, 25) \
                * 1e3 / GRID_SUBSTEPS

        pack, step, _, _ = mod.make_frame_stepper(arr)
        times["unsharded"] = fit(step, pack(st, params), lambda p: p[0])
        for d in (1, 2, 4):
            prepare, step, _ = make(SlabMesh(d), arr)
            setattr(mod, counter, 0)
            times[d] = fit(step, prepare(st, params),
                           lambda p: (p.pos if polar else p[0])[0])
            per = getattr(mod, counter) / (1 + 25 + 5)
            times[f"launches {d}"] = per
        if polar:
            twin = polar_grid.make_grid_sharded_step(SlabMesh(4), arr)
            slab, sarr = polar_grid.grid_prepare(st, arr, SlabMesh(4))
            tstep = (lambda p, prm, c: twin(p, sarr, prm, c)[0])
            tp = slab
            work = (mod.frame_flops(arr, one, 1), mod.frame_bytes(arr, 1, 1))
        else:
            twin = neohookean_grid.make_nh_sharded_step(SlabMesh(4), arr)
            tstep = (lambda p, prm, c: twin(p, prm, c)[0])
            tp = neohookean_grid.nh_prepare(st, arr, SlabMesh(4))
            work = (mod.frame_flops(arr, one, 1),
                    mod.frame_bytes(arr, one, 1, 1))
        tstate = {"p": tp}

        def trun(k):
            for _ in range(k):
                tstate["p"] = tstep(tstate["p"], params, ctl)

        twin_ms = per_frame(trun, lambda: (tstate["p"].pos if polar
                                           else tstate["p"][0])[0].sum(),
                            1, 2) * 1e3 / GRID_SUBSTEPS
        unsharded = (f"{mod.LAUNCHES_PER_SUBSTEP} launches per substep"
                     if polar
                     else f"{mod.LAUNCHES_PER_FRAME} launch per frame")
        print(f"phase 23 [{label}] {name} slab form at {GRID}: "
              + ", ".join(f"{d} slab{'s' if d > 1 else ''} {times[d]:.4f} "
                          f"ms/substep ({times[f'launches {d}']:.0f} launches "
                          "per frame)" for d in (1, 2, 4))
              + f"; unsharded {times['unsharded']:.4f} ms/substep "
              f"({unsharded}); sharded twin at 4 slabs {twin_ms:.3f} "
              "ms/substep", flush=True)
        out[mod] = (times[4], twin_ms, bound(*work))
    return out


def large_timings(tt, label):
    """Phase 23, the large bodies: ms per frame (5 substeps) of the
    multi-block kernels on grid_mesh(20, 20, 20) through Body, and of their
    twins.  Returns {module: (ms, plain ms, bound)}."""
    from tetsim_torch.kernels import gs_levels, polar_jacobi

    mesh = tt.grid_mesh(*LARGE, **LARGE_BOX)
    out = {}
    for engine, mod in (("neohookean", gs_levels), ("polar", polar_jacobi)):
        world = tt.World()
        body = world.add_body(mesh, engine=engine)
        params = world.params
        k_ms = per_frame(lambda k: world.step(k),
                         lambda: body.state.pos.sum(), 10, 50) * 1e3
        s = body.state
        gid, gpos = no_grab(1)
        twin = {"s": [s.pos[None], s.vel[None]]
                + ([s.quats[None]] if engine == "polar" else [])}

        def plain_step(k):
            for _ in range(k):
                if engine == "polar":
                    r = mod.jacobi_frame_reference(*twin["s"], body.arrays,
                                                   params, gid, gpos)
                    twin["s"] = [r[0], r[2], r[3]]
                else:
                    r = mod.levels_frame_reference(*twin["s"], body.arrays,
                                                   params, gid, gpos)
                    twin["s"] = [r[0], r[2]]

        p_ms = per_frame(plain_step, lambda: twin["s"][0].sum(), 1, 3) * 1e3
        if engine == "polar":
            work = (mod.frame_flops(body.arrays, params, 1),
                    mod.frame_bytes(body.arrays, 1, 1))
        else:
            work = (mod.frame_flops(body.arrays, params, 1),
                    mod.frame_bytes(body.arrays, params, 1, 1))
        per = mod.LAUNCHES_PER_FRAME
        print(f"phase 23 [{label}] {mod.__name__.split('.')[-1]} Body "
              f"{LARGE}: {k_ms:.4f} ms/frame at {params.num_substeps} "
              f"substeps ({per} launches per frame), plain twin "
              f"{p_ms:.3f} ms/frame", flush=True)
        out[mod] = (k_ms, p_ms, bound(*work))
    return out


# -- the multi-device surface and the rest of the public surface -------------


def body_meshes(DeviceMesh):
    """The body axis on the one card repeated 2 and 4 times, and, where the
    host has several cards, over distinct cards."""
    out = [(f"{d} shards on one card", DeviceMesh(["cuda"] * d, "body"))
           for d in (2, 4)]
    n = torch.cuda.device_count()
    if n > 1:
        d = max(k for k in (2, 4, 8) if k <= n)
        out.append((f"{d} distinct cards",
                    DeviceMesh([f"cuda:{i}" for i in range(d)], "body")))
    return out


def sharded_batches(tt, gs_fused, polar_fused, dragon, label):
    """Phase 24: returns ms per frame {batch: [1, 2, 4 shards on one
    card]}."""
    from tetsim_torch.parallel import (DeviceMesh, batch_controls,
                                       batch_state, make_sharded_step,
                                       prepare)

    where = ("one card" if torch.cuda.device_count() == 1
             else f"{torch.cuda.device_count()} cards")
    nh, gpu = tt.default_cpu_params(), tt.default_gpu_params()
    target = dragon.verts[100] + np.float32([0.0, 0.3, 0.1])
    kinds = (("FusedGSBody greedy", gs_fused, nh, ("last_diag",),
              lambda: gs_fused.FusedGSBody(dragon, 8, jitter=0.3, seed=5)),
             ("FusedPolarBody", polar_fused, gpu, ("quats",),
              lambda: polar_fused.FusedPolarBody(dragon, 8, jitter=0.3,
                                                 seed=5)))
    times = {}
    for name, mod, params, extra, make in kinds:
        for mlabel, mesh in body_meshes(DeviceMesh):
            ref, sh = make(), make().shard(mesh, "body")
            for b in (ref, sh):
                b.set_grab(5, 100, target)
            d = len(sh.parts)
            for f in range(3):
                ref.step(params)
                mod.launch_count = 0
                with no_host_sync():
                    sh.step(params)
                check(mod.launch_count == d,
                      f"{name} on {mlabel}: {mod.launch_count} launches")
                for fld in ("pos", "prev_pos", "vel") + extra:
                    check(torch.equal(getattr(sh, fld), getattr(ref, fld)),
                          f"{name} on {mlabel}: {fld} differs at frame {f}")
            check(max_diff(sh.pos[5, 100], torch.as_tensor(target).cuda())
                  <= 1e-6, f"{name} on {mlabel}: grab off target")
            print(f"phase 24 {name} B=8 on {mlabel}: 3 frames bit for bit "
                  f"the unsharded batch (positions, prev, velocities, "
                  f"{extra[0]}), {d} launches per frame, no host sync, the "
                  "grab on body 5 at its target", flush=True)
        ms = []
        for d in (1, 2, 4):
            b = make()
            if d > 1:
                b.shard(DeviceMesh(["cuda"] * d, "body"))
            ms.append(per_frame(lambda k, b=b: b.step(params, k),
                                lambda b=b: b.pos.sum(), 20, 120) * 1e3)
        times[name] = ms
        print(f"phase 24 [{label}] {name} B=8 ms per frame at 1 / 2 / 4 "
              f"shards on one card: {ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f}",
              flush=True)

    for engine, params, coloring, mod in (
            ("neohookean", nh, "ordered", gs_fused),
            ("polar", gpu, None, polar_fused)):
        arr = tt.build_arrays(dragon, coloring=coloring, device="cuda")
        start = batch_state(tt.init_state(dragon, "cuda"), 8, jitter=0.3,
                            seed=5)
        ctl = batch_controls(8, "cuda")
        ctl.grab_id[5] = 100
        ctl.grab_pos[5] = torch.as_tensor(target)
        refs, s = [], start
        for _ in range(3):
            bodies = [tt.get_engine(engine).step_frame(
                tt.SimState(*(x[i] for x in (s.pos, s.prev_pos, s.vel,
                                             s.quats))),
                arr, params, tt.Controls(ctl.grab_id[i], ctl.grab_pos[i]))
                for i in range(8)]
            s = tt.SimState(*(torch.stack([getattr(b, f) for b, _ in bodies])
                              for f in ("pos", "prev_pos", "vel", "quats")))
            refs.append((s, torch.stack([dg for _, dg in bodies])))
        for mlabel, mesh in body_meshes(DeviceMesh):
            s, tables = prepare(start, arr, mesh, engine, tet_axis=None,
                                body_axis="body")
            step = make_sharded_step(mesh, engine, tet_axis=None,
                                     body_axis="body")
            mod.launch_count = 0
            for f, (ref, rdiag) in enumerate(refs):
                s, diag = step(s, tables, params, ctl)
                for fld in ("pos", "prev_pos", "vel", "quats"):
                    check(torch.equal(getattr(s, fld), getattr(ref, fld)),
                          f"make_sharded_step {engine} on {mlabel}: {fld} "
                          f"differs from the engine at frame {f}")
                check(torch.equal(diag, rdiag), f"{engine} diags differ")
            d = mesh.shape["body"]
            check(mod.launch_count == 3 * d,
                  f"{engine} body axis: {mod.launch_count} launches")
            print(f"phase 24 make_sharded_step {engine} body axis, 8 "
                  f"jittered dragons with a grab on {mlabel}: 3 frames bit "
                  f"for bit the engine's step_frame body by body, {d} "
                  "launches per frame", flush=True)
    print(f"phase 24 ran on {where}", flush=True)
    return times


def spread_frames(step, start, frames):
    """Positions after each of ``frames`` frames from ``start`` and from
    positions one ulp above it."""
    out = []
    for pos in (start.pos, torch.nextafter(start.pos,
                                           torch.full_like(start.pos, 1e9))):
        s, run = start.replace(pos=pos), []
        for _ in range(frames):
            s = step(s)
            run.append(s.pos)
        out.append(run)
    return out[0], [max_diff(a, b) for a, b in zip(*out)]


def tet_axis(tt, dragon, label):
    """Phase 25: returns the largest position difference from the
    unsharded engine."""
    from tetsim_torch.kernels import gs_fused, polar_fused
    from tetsim_torch.parallel import DeviceMesh, make_sharded_step, prepare
    from tetsim_torch.parallel import nh_shard

    rng = np.random.RandomState(13)
    vel = rng.uniform(-0.3, 0.3, (dragon.num_particles, 3)).astype(np.float32)
    start = tt.init_state(dragon, "cuda")
    start = start.replace(vel=torch.as_tensor(vel).cuda())
    # a gentle grab: a pull of 0.3 makes the polar frame chaotic (a 1-ulp
    # spread of 1e-3 in a frame), 0.05 keeps it near 1e-6
    target = torch.as_tensor(dragon.verts[100] + np.float32([0.0, 0.05, 0.0]))
    ctl = tt.Controls(torch.tensor(100, dtype=torch.int32, device="cuda"),
                      target.cuda())
    worst = 0.0
    for engine, params, coloring, frames, mod in (
            ("polar", tt.default_gpu_params(), None, 2, polar_fused),
            ("neohookean", tt.default_cpu_params(), "greedy", 1, gs_fused)):
        arr = tt.build_arrays(dragon, coloring=coloring, device="cuda")
        eng = tt.get_engine(engine)
        ref, spread = spread_frames(
            lambda s: eng.step_frame(s, arr, params, ctl)[0], start, frames)
        for d in (2, 4):
            mesh = DeviceMesh(["cuda"] * d, "tet")
            s, tables = prepare(start, arr, mesh, engine, "tet")
            step = make_sharded_step(mesh, engine, "tet")
            mod.launch_count = 0
            errs = []
            for f in range(frames):
                s, _ = step(s, tables, params, ctl)
                errs.append(max_diff(s.pos, ref[f]))
                bar = max(2e-5, 2 * spread[f])
                check(errs[-1] <= bar, f"{engine} tet axis x{d} frame {f}: "
                      f"{errs[-1]:.3e} > {bar:.3e}")
            check(mod.launch_count == 0, f"{engine} tet axis launched "
                  "the fused kernel: it runs plain torch")
            check(max_diff(s.pos[100], target.cuda()) <= 1e-6, "grab off")
            worst = max(worst, *errs)
            box = {"s": s}

            def advance(k):
                for _ in range(k):
                    box["s"], _ = step(box["s"], tables, params, ctl)

            ms = per_frame(advance, lambda: box["s"].pos.sum(), 1, 2) * 1e3
            extra = ""
            if engine == "neohookean":
                t = tables.shares[0].tables
                extra = (f"; exchange {nh_shard.comm_bytes_per_substep(t):,} "
                         f"bytes per substep ({t.L} levels x Eb {t.Eb} x 12) "
                         f"against the dense {t.L * t.num_particles * 12:,} "
                         f"(levels x N x 12), plus the ownership combine "
                         f"{36 * t.num_particles:,} per frame")
            print(f"phase 25 [{label}] {engine} tet axis, the dragon in {d} "
                  f"shards on one card, {frames} frame(s) with a grab from "
                  f"seeded velocities: max |dpos| "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + " vs the unsharded engine (1-ulp spread "
                  + ", ".join(f"{e:.3e}" for e in spread)
                  + f"), plain torch, {ms:.2f} ms per frame{extra}",
                  flush=True)
    return worst


def run_example(name, argv):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(argv)


def surface(tt, gs_fused, polar_fused, polar_stencil, dragon):
    """Phase 26: TetGen and npz round trips of the dragon, the three
    examples.  Its diag.trace check is phase 28's."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        node, ele = os.path.join(tmp, "d.node"), os.path.join(tmp, "d.ele")
        with open(node, "w") as f:
            f.write(f"# the dragon\n{dragon.num_particles} 3 0 0\n")
            for i, (x, y, z) in enumerate(dragon.verts):
                f.write(f"{i + 1} {float(x)!r} {float(y)!r} "
                        f"{float(z)!r}\n")
        with open(ele, "w") as f:
            f.write(f"{dragon.num_tets} 4 0\n")
            for i, t in enumerate(dragon.tets):
                f.write(f"{i + 1} " + " ".join(str(v + 1) for v in t) + "\n")
        m = tt.load_tetgen(node, ele)
        check(np.array_equal(m.verts, dragon.verts), "TetGen vertices")
        check(np.array_equal(np.sort(m.tets, 1), np.sort(dragon.tets, 1)),
              "TetGen tets")
        flipped = int((m.tets != dragon.tets).any(axis=1).sum())
        npz = os.path.join(tmp, "d.npz")
        tt.save_npz(npz, dragon)
        back = tt.load_npz(npz)
        check(all(np.array_equal(getattr(back, f), getattr(dragon, f))
                  for f in ("verts", "tets", "edges", "vis_tet_ids",
                            "vis_bary", "tris")), "npz round trip")
        world = tt.World(tt.default_gpu_params())
        body = world.add_body(m, engine="polar")
        world.step(3)
        check(np.isfinite(body.positions).all(), "TetGen dragon not finite")
        print(f"phase 26 mesh IO: the dragon through a 1-based .node/.ele "
              f"pair ({m.num_particles} nodes, {m.num_tets} tets, "
              f"{flipped} reoriented, {len(m.edges)} edges) and an npz round "
              "trip, equal; 3 polar frames of it on the card", flush=True)

        gs_fused.launch_count = polar_fused.launch_count = 0
        run_example("torch_drop_dragon",
                    ["--frames", "3", "--checkpoint",
                     os.path.join(tmp, "dragon.npz")])
        check((gs_fused.launch_count, polar_fused.launch_count) == (3, 3),
              "drop_dragon launches")
        polar_stencil.launch_count = 0
        beam = run_example("torch_cantilever", ["--frames", "3"])
        check(polar_stencil.launch_count == 3 * 8 * 2, "cantilever launches")
        check(bool(torch.isfinite(beam.pos).all()), "cantilever not finite")
        polar_stencil.launch_count = 0
        world = run_example("torch_scale_grid", ["--frames", "3"])
        check(polar_stencil.launch_count == 6 * 5 * 2, "scale_grid launches")
        check(not world.diagnostics()["body0"]["nan"], "scale_grid NaN")
        print("phase 26 examples on the card: torch_drop_dragon (3 frames "
              "each engine, K1 x3, K2 x3, a checkpoint), torch_cantilever "
              "(3 frames, K4 x48, pins held, tip sagging), "
              "torch_scale_grid (16^3 packed, 3 + 3 frames, K4 x60)",
              flush=True)


# -- the one torch.profiler session ---------------------------------------------

def traced(tt, dragon, params, dense_bodies, dense_times, label):
    """Phase 28, the script's only torch.profiler session (one session
    leaves later launches slower on the host, so it comes last): diag.trace
    around one dense frame at B = 8, one at B = 128 and 3 polar World
    frames, each in its own ``record_function`` range that ends with a
    sync.  Each kernel is put in the range that launched it (the kernel's
    correlation id names its launch call on the host's clock).  The dense
    frames launch one dense_frame kernel each and no gemm; the polar frames
    polar_frame_kernel 3 times; no kernel falls outside the ranges."""
    import json
    import os
    import tempfile

    from tetsim_torch import diag

    world = tt.World(tt.default_gpu_params())
    world.add_body(dragon, engine="polar")
    world.step(1)
    steps = {f"dense B={b}": (lambda body=body: body.step(params))
             for b, body in dense_bodies.items()}
    steps["polar 3 frames"] = lambda: world.step(3)
    for fn in steps.values():
        fn()
    sync()
    with tempfile.TemporaryDirectory() as tmp:
        with diag.trace(os.path.join(tmp, "trace")) as t:
            for name, fn in steps.items():
                with torch.profiler.record_function(name):
                    fn()
                    sync()
        size = os.path.getsize(t.path)
        with open(t.path) as f:
            events = json.load(f)["traceEvents"]

    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in steps}
    check(set(ranges) == set(steps), f"trace: ranges {sorted(ranges)}")
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kern = [e for e in events if e.get("cat") == "kernel"]
    by_range = {name: [] for name in steps}
    for e in kern:
        ts = launch_ts.get(e.get("args", {}).get("correlation"),
                           float(e["ts"]))
        inside = [n for n, (t0, t1) in ranges.items() if t0 <= ts <= t1]
        check(len(inside) == 1, f"trace: kernel {e.get('name')} at {ts} "
              f"in ranges {inside}")
        by_range[inside[0]].append(e)
    polar = sum("polar_frame_kernel" in e.get("name", "")
                for e in by_range["polar 3 frames"])
    check(polar == 3, f"trace: {polar} polar_frame_kernel events of "
          f"{len(by_range['polar 3 frames'])} kernel events in 3 polar frames")
    print(f"phase 28 diag.trace: {size:,} bytes, {len(events)} events, "
          f"{len(kern)} kernel events, polar_frame_kernel x{polar} for 3 "
          "polar frames", flush=True)
    for b in dense_bodies:
        kinds = {"dense_frame": 0, "gemm": 0, "other": 0}
        us = dict.fromkeys(kinds, 0.0)
        for e in by_range[f"dense B={b}"]:
            name = e.get("name", "")
            kind = ("dense_frame" if "dense_frame_kernel" in name else
                    "gemm" if "gemm" in name.lower() else "other")
            kinds[kind] += 1
            us[kind] += float(e.get("dur", 0.0))
        check(kinds["dense_frame"] == 1 and kinds["gemm"] == 0,
              f"the dense B={b} frame's kernels {kinds}")
        ms = dense_times[b][0]
        busy = sum(us.values()) / 1e3
        print(f"phase 28 [{label}] dense dragon B={b}: one frame (traced) "
              f"launches {sum(kinds.values())} kernels, {busy:.4f} ms of "
              f"them on the card ({busy / ms:.1%} of the frame's "
              f"{ms:.4f} ms): " + ", ".join(
                  f"{k} {n} ({us[k] / 1e3:.4f} ms)" for k, n in kinds.items()),
              flush=True)


# -- the dense engine (dense_frame) --------------------------------------------

DENSE_B = 128  # the dense dragon batch measured on the TPU (BENCHNOTES.md)
DENSE_FRAMES = 3


def dense_engine(tt, dense_frame, dragon, label):
    """Phase 27: World -> add_body_batch(dragon, 128, engine="neohookean",
    backend="dense", jitter=0.5) on the card, greedy colouring, a grab on
    body 5; 3 frames with no host sync, held after each to the plain twin
    (``dense.frame_reference``: the products and the plain level solve) at
    positions 2e-5 and velocities 2e-3 or twice the kernel path's own
    spread from a start 1 ulp apart; one frame-kernel launch a frame and
    the twin never called; a NaN, an inf and 1e30 planted in one particle
    of body 0, the twin's NaN masks after each frame and the other bodies'
    bits unmoved; with TF32 on the kernel's bits and the twin's refusal;
    save -> World.load(device="cuda") bitwise after one more frame; the
    batch's peak memory below the one-hot's bytes, the one-hot not built;
    one substep of 8 dragons on the ordered colouring and a frame of 8
    boxes of 2,197 particles (C = 512) against the twin, within the same
    bars; the two forms bitwise alike (``dense_forms``); the two bodies
    past one block's shared memory (``dense_wide``); then ms per frame at
    B = 8 and 128 by the host's clock and by CUDA events, and the twin's.
    Returns the kernel's JSON row, the global form's, the bodies of B = 8
    and 128 and their (ms, event ms, twin ms), from which phase 28 traces a
    frame each."""
    from tetsim_torch._compile import BUILD_DIR
    from tetsim_torch.solvers import dense
    from tetsim_torch.world import DenseBody

    params = tt.default_cpu_params()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    world = tt.World(tt.default_cpu_params())
    batch = world.add_body_batch(dragon, DENSE_B, engine="neohookean",
                                 backend="dense", jitter=0.5)
    check(type(batch) is DenseBody, "backend='dense' is not DenseBody")
    arr = batch.arrays
    L, C = arr.num_levels, arr.slots_per_level
    slab = L * dragon.num_particles * 4 * C * 4  # the twin's one-hot, bytes
    pid = batch.start_grab(5, batch.positions()[5].mean(axis=0))
    target = batch.positions()[5, pid] + np.float32([0.0, 0.05, 0.0])
    batch.move_grabbed(5, target)
    start = batch.state
    gid, gpos = batch.grab_id, batch.grab_pos
    twin = dense.frame_reference

    saved = dense.frame_reference, dense.dense_level_reference
    dense.frame_reference = dense.dense_level_reference = None  # raise
    dense_frame.launch_count = 0
    dense_frame.form_launches.update(dict.fromkeys(dense_frame.FORMS, 0))
    dense_frame.cluster_launches.update(
        dict.fromkeys(dense_frame.cluster_launches, 0))
    try:
        got = []
        with no_host_sync():
            for _ in range(DENSE_FRAMES):
                world.step(1)
                got.append(batch.state)
    finally:
        dense.frame_reference, dense.dense_level_reference = saved
    launches = dense_frame.launch_count
    check(launches == DENSE_FRAMES
          and dense_frame.form_launches["shared"] == DENSE_FRAMES
          and not any(dense_frame.cluster_launches.values()),
          f"{launches} frame-kernel launches for {DENSE_FRAMES} frames "
          f"({dense_frame.form_launches}, global form at each cluster "
          f"{dense_frame.cluster_launches})")
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    built = "onehot" in vars(arr)
    print(f"phase 27 the dense batch built and stepped {DENSE_FRAMES} frames "
          f"on the card with {peak / 1e6:.1f} MB at its peak, the one-hot "
          f"({slab / 1e6:.1f} MB) built {built}", flush=True)
    check(not built and peak < slab, "the card's path built the one-hot")

    def frames(s, step=dense.step_frame):
        """Each state of ``DENSE_FRAMES`` frames from s."""
        out = []
        for _ in range(DENSE_FRAMES):
            s = step(s, arr, params, gid, gpos)
            out.append(s)
        return out

    t0 = time.perf_counter()
    want = frames(start, twin)
    sync()
    twin_s = (time.perf_counter() - t0) / DENSE_FRAMES
    moved = [frames(st) for st in (start.replace(pos=ulp(start.pos, 10.0)),
                                   start.replace(pos=ulp(start.pos, -10.0)),
                                   start.replace(vel=ulp(start.vel, 10.0)))]
    err = 0.0
    for f, (k, r, *m) in enumerate(zip(got, want, *moved), 1):
        sp = max(max_diff(k.pos, x.pos) for x in m)
        sv = max(max_diff(k.vel, x.vel) for x in m)
        err = max(err, hold(
            f"phase 27 dense B={DENSE_B} frame {f} of {DENSE_FRAMES}",
            [("pos", k.pos, r.pos, 2e-5, sp), ("vel", k.vel, r.vel, 2e-3, sv)]))
    last = got[-1].pos
    check(torch.equal(last[pid, :, 5], gpos[:, 5]), "grab off target")
    check(bool(torch.isfinite(last).all()) and last.is_contiguous()
          and tuple(last.shape) == (dragon.num_particles, 3, DENSE_B),
          "positions")
    diag_ = world.diagnostics()["body0"]
    check(diag_["batch"] == DENSE_B and not diag_["nan"], f"diagnostics {diag_}")
    print(f"phase 27 add_body_batch(dragon, {DENSE_B}, backend='dense'): L = "
          f"{L} levels of C = {C} slots, {launches} frame-kernel launches for "
          f"{DENSE_FRAMES} frames, the twin not called, grab pid {pid} of "
          f"body 5 at target, diagnostics {diag_}; the twin {twin_s:.3f} s "
          "per frame", flush=True)

    # NaN and inf spread as the products spread them: body 0 NaN, the other
    # bodies' bits those of the main run
    for name, plant, coords in (("a NaN", float("nan"), 1),
                                ("an inf", float("inf"), 1),
                                ("1e30", 1e30, slice(None))):
        s0 = start.replace(pos=start.pos.clone())
        s0.pos[11, coords, 0] = plant
        ks, rs = frames(s0), frames(s0, twin)
        masks = all(torch.equal(torch.isnan(getattr(k, a)),
                                torch.isnan(getattr(r, a)))
                    for k, r in zip(ks, rs) for a in ("pos", "prev_pos", "vel"))
        rest = all(torch.equal(getattr(k, a)[..., 1:], getattr(g, a)[..., 1:])
                   for k, g in zip(ks, got) for a in ("pos", "prev_pos", "vel"))
        body0 = int(torch.isnan(ks[-1].pos[..., 0]).sum())
        print(f"phase 27 {name} in particle 11 of body 0 (y; 1e30 in each "
              f"coordinate): the twin's NaN masks after each of "
              f"{DENSE_FRAMES} frames {masks}, the other bodies bitwise the "
              f"main run {rest}, body 0 NaN in {body0} of "
              f"{3 * dragon.num_particles} coordinates", flush=True)
        check(masks and rest and body0 == 3 * dragon.num_particles,
              f"phase 27 {name} spreads otherwise than in the twin")

    torch.set_float32_matmul_precision("high")
    try:
        tf32 = dense.step_frame(start, arr, params, gid, gpos)
        same = all(torch.equal(getattr(tf32, a), getattr(got[0], a))
                   for a in ("pos", "prev_pos", "vel"))
        try:
            twin(start, arr, params, gid, gpos)
            refused = False
        except RuntimeError as e:
            refused = "TF32" in str(e)
    finally:
        torch.set_float32_matmul_precision("highest")
    print(f"phase 27 TF32 on: the kernel's frame bitwise the frame with it "
          f"off {same}, the twin refuses {refused}", flush=True)
    check(same and refused, "phase 27 TF32")

    path = f"{BUILD_DIR}/phase27_scene.npz"  # inside the checkout, ignored
    world.save(path)
    loaded = tt.World.load(path, device="cuda")
    world.step(1)
    loaded.step(1)
    a, b = world.bodies[0], loaded.bodies[0]
    keys = ("pos", "prev_pos", "vel", "grab_id", "grab_pos")
    same = (type(b) is DenseBody
            and all(getattr(b, k).is_contiguous() for k in keys)
            and all(torch.equal(getattr(a, k), getattr(b, k)) for k in keys))
    print(f"phase 27 save -> World.load(device='cuda'), one more frame in "
          f"each: bitwise equal {same}", flush=True)
    check(same, "the loaded dense world steps differently")

    def other_mesh(label, body, prm):
        """One frame of ``body`` against the twin, within 2e-5 / 2e-3 or
        twice the kernel's spread from starts 1 ulp apart."""
        s, a = body.state, body.arrays
        k, *m = (dense.step_frame(x, a, prm, body.grab_id, body.grab_pos)
                 for x in (s, s.replace(pos=ulp(s.pos, 10.0)),
                           s.replace(pos=ulp(s.pos, -10.0))))
        r = twin(s, a, prm, body.grab_id, body.grab_pos)
        return hold(label, [
            ("pos", k.pos, r.pos, 2e-5, max(max_diff(k.pos, x.pos) for x in m)),
            ("vel", k.vel, r.vel, 2e-3, max(max_diff(k.vel, x.vel) for x in m))])

    # the ordered colouring (C = 128: half the block solves), one substep at
    # the default substep's dt (one of 1/60 s is chaotic over 703 levels:
    # a start 1 ulp apart moves positions by 1.3), the twin taking seconds
    ordered = DenseBody(dragon, 8, coloring="ordered", jitter=0.5)
    err = max(err, other_mesh(
        f"phase 27 dense ordered B=8 ({ordered.arrays.num_levels} levels of "
        f"C = {ordered.arrays.slots_per_level}), one substep of 1/300 s",
        ordered, tt.PhysicsParams(num_substeps=1, time_step=1.0 / 300.0)))
    del ordered
    # a mesh past the block's width (C = 512: two slots a thread) and past
    # the particles whose prev a thread keeps in registers (2,197 > 2,048)
    box = DenseBody(tt.grid_mesh(12, 12, 12, cell=0.1,
                                 origin=(-0.5, 0.3, -0.5)), 8, jitter=0.5)
    err = max(err, other_mesh(
        f"phase 27 dense grid_mesh(12, 12, 12) B=8 ({box.mesh.num_particles} "
        f"particles, {box.arrays.num_levels} levels of C = "
        f"{box.arrays.slots_per_level}), one frame", box, params))
    del box

    dense_forms(dense_frame, dragon, params, label)
    global_row = dense_wide(tt, dense_frame, params, label)

    # times at B = 8 and 128: the frame by the host's clock and by CUDA
    # events, the twin's frame; the trace of one frame is phase 28's
    out, bodies = {}, {}
    for b in (8, DENSE_B):
        body = bodies[b] = DenseBody(dragon, b, jitter=0.5)
        ms = per_frame(lambda k: body.step(params, k), lambda: body.pos.sum(),
                       20, 200) * 1e3
        k_ms = event_ms(lambda: body.step(params), 100)
        p_ms = event_ms(lambda: twin(body.state, arr, params, body.grab_id,
                                     body.grab_pos), 1)
        out[b] = (ms, k_ms, p_ms)
        b_ms, b_by = bound(dense_frame.frame_flops(arr, params, b),
                           dense_frame.frame_bytes(arr, b))
        print(f"phase 27 [{label}] dense dragon B={b}: {ms:.4f} ms per frame "
              f"(two-point fit over 20 and 200 frames, "
              f"{b * params.num_substeps / ms * 1e3:.1f} body-substeps/s), "
              f"{k_ms:.4f} ms by CUDA events; bound {b_ms * 1e3:.3f} us "
              f"({b_by}, {b_ms / k_ms:.1%} of it); the twin {p_ms:.1f} ms "
              "per frame", flush=True)

    _, k_ms, p_ms = out[DENSE_B]
    b_ms, b_by = bound(dense_frame.frame_flops(arr, params, DENSE_B),
                       dense_frame.frame_bytes(arr, DENSE_B))
    return {"name": "dense_frame", "route": "cuda",
            "source": "tetsim_torch/kernels/csrc/dense_frame.cu",
            "replaces": "none: the XLA engine (tetsim_tpu/solvers/dense.py:184)",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, global_row, bodies, out


def ulp(x, to):
    """x moved 1 ulp toward ``to``."""
    return torch.nextafter(x, torch.full_like(x, to))


def same_bits(a, b) -> bool:
    """torch.equal with NaN equal to NaN: equal NaN masks, and every other
    value bitwise."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


def dense_grab(start, b):
    """grab_id / grab_pos of b bodies: body 5, where the batch has one,
    holds particle 7 5 cm above its start."""
    gid = torch.full((b,), -1, dtype=torch.int32, device="cuda")
    gpos = torch.zeros((3, b), device="cuda")
    if b > 5:
        gid[5] = 7
        gpos[:, 5] = start.pos[7, :, 5] + torch.tensor([0.0, 0.05, 0.0],
                                                      device="cuda")
    return gid, gpos


def dense_forms(dense_frame, dragon, params, label):
    """Phase 27: 8 dragons (jittered 0.5, body 5 holding a particle 5 cm
    up) on the greedy and the ordered colouring, each forced onto the
    shared and the global form of dense_frame: the same bits after each of
    3 frames, from the start and with a NaN planted in particle 11 of body
    0 (NaN masks equal); one launch of the forced form a frame; each
    form's ms a frame by CUDA events."""
    from tetsim_torch.solvers import dense

    for coloring in ("greedy", "ordered"):
        arr = dense.build_dense_arrays(dragon, coloring=coloring,
                                       device="cuda")
        start = dense.init_dense_state(dragon, 8, jitter=0.5, device="cuda")
        gid, gpos = dense_grab(start, 8)
        nan = start.pos.clone()
        nan[11, 1, 0] = float("nan")
        for name, pos in (("from the start", start.pos),
                          ("a NaN in body 0", nan)):
            runs = {}
            for form in dense_frame.FORMS:
                before = dense_frame.form_launches[form]
                p, v, out = pos, start.vel, []
                for _ in range(DENSE_FRAMES):
                    p, q, v = dense_frame.dense_frame(p, v, arr, params, gid,
                                                      gpos, form=form)
                    out.append((p, q, v))
                runs[form] = out, dense_frame.form_launches[form] - before
            (a, na), (b, nb) = runs["shared"], runs["global"]
            same = all(same_bits(x, y) for fa, fb in zip(a, b)
                       for x, y in zip(fa, fb))
            print(f"phase 27 dense dragon B=8 {coloring} ({arr.num_levels} "
                  f"levels), {name}: the global form bitwise the shared "
                  f"form after each of {DENSE_FRAMES} frames, NaN masks "
                  f"equal, {same}; launches {na} shared, {nb} global",
                  flush=True)
            check(same and na == nb == DENSE_FRAMES,
                  f"phase 27 the two forms differ ({coloring}, {name})")
        ms = {form: event_ms(lambda form=form: dense_frame.dense_frame(
            start.pos, start.vel, arr, params, gid, gpos, form=form), 20)
              for form in dense_frame.FORMS}
        print(f"phase 27 [{label}] dense dragon B=8 {coloring}: "
              + ", ".join(f"the {f} form {t:.4f} ms" for f, t in ms.items())
              + " per frame by CUDA events", flush=True)


WIDE_BS = (8, 1)  # the batches of the bodies past one block's shared memory
WIDE_FRAMES = 2


def dense_wide(tt, dense_frame, params, label):
    """Phase 27: the two bodies past one block's shared memory at B = 8 and
    1, jittered 0.5, on the global form (the launch plan's choice, a
    cluster of more than one block per body): replicate_mesh(
    single_tet_mesh(), 4843) (19,372 particles, L = 1, C = 4,864; the
    twin's one-hot 1.508 GB) through World.add_body_batch(...,
    backend="dense"), and replicate_mesh(grid_mesh(1, 1, 1, cell=0.1), 2422)
    (19,376 particles, L = 6, C = 2,432; 4.52 GB) through
    dense.build_dense_arrays(..., max_bytes=5e9) and dense.step_frame; at
    B = 8 body 5 holds a particle 5 cm up, the copies of each jittered
    apart.  Each: 2 frames with no host sync, one global-form launch a frame
    on the plan's cluster (the wrapper's count of the global form's
    launches at each cluster size) and the one-hot not built, held after each frame to the twin at 2e-5 /
    2e-3 or twice the kernel's spread from starts 1 ulp apart; a NaN
    planted in particle 11 of body 0: one launch a frame, the twin's NaN
    masks, body 0 all NaN, the other bodies bitwise the clean run; the
    plan's cluster bitwise a cluster of one block after each frame, clean
    and with a NaN, then an inf, planted in body 0; then ms a frame by CUDA
    events at the plan's cluster and at one block, the bound and its
    share, the twin's frame.  Returns the global form's JSON row (the World
    body's numbers at B = 8 with its cluster; the error the largest of
    all)."""
    from tetsim_torch.mesh import single_tet_mesh
    from tetsim_torch.solvers import dense
    from tetsim_torch.world import DenseBody

    keys = ("pos", "prev_pos", "vel")

    def reset():
        dense_frame.launch_count = 0
        dense_frame.form_launches.update(dict.fromkeys(dense_frame.FORMS, 0))
        dense_frame.cluster_launches.update(
            dict.fromkeys(dense_frame.cluster_launches, 0))

    def frames(s, arr, gid, gpos, step):
        out = []
        for _ in range(WIDE_FRAMES):
            s = step(s, arr, params, gid, gpos)
            out.append(s)
        return out

    def at_cluster(cs):
        """dense.step_frame's launch with the global form's cluster forced
        to cs blocks."""
        def step(s, arr, prm, gid, gpos):
            return dense.DenseState(*dense_frame.dense_frame(
                s.pos, s.vel, arr, prm, gid, gpos, cs=cs))
        return step

    def case(name, arr, start, gid, gpos, got, launches, clusters):
        """The checks and times of one body; ``got`` the kernel's states
        after each frame of the main path from ``start``, ``launches`` its
        launches of each form, ``clusters`` its global-form launches at
        each cluster size."""
        n, b = arr.num_particles, start.pos.shape[2]
        plan = dense_frame.launch_plan(
            b, n, arr.slots_per_level,
            waves=dense_frame.active_clusters(start.pos.device))
        cs = plan.cluster
        print(f"phase 27 {name} B={b}: {n} particles, L = {arr.num_levels} "
              f"levels of C = {arr.slots_per_level}, plan {plan}, launches "
              f"{launches} for {WIDE_FRAMES} frames, at each cluster "
              f"{clusters}, the one-hot built {'onehot' in vars(arr)}",
              flush=True)
        ran = {c: k for c, k in clusters.items() if k}
        check(plan.form == "global" and cs > 1
              and launches == {"shared": 0, "global": WIDE_FRAMES}
              and ran == {cs: WIDE_FRAMES} and "onehot" not in vars(arr),
              f"phase 27 {name} B={b}: not one global-form launch a frame "
              f"on the plan's cluster of {cs} blocks ({ran})")
        want = frames(start, arr, gid, gpos, dense.frame_reference)
        moved = [frames(st, arr, gid, gpos, dense.step_frame)
                 for st in (start.replace(pos=ulp(start.pos, 10.0)),
                            start.replace(pos=ulp(start.pos, -10.0)))]
        err = 0.0
        for f, (k, r, *m) in enumerate(zip(got, want, *moved), 1):
            sp = max(max_diff(k.pos, x.pos) for x in m)
            sv = max(max_diff(k.vel, x.vel) for x in m)
            err = max(err, hold(
                f"phase 27 {name} B={b} frame {f} of {WIDE_FRAMES}",
                [("pos", k.pos, r.pos, 2e-5, sp),
                 ("vel", k.vel, r.vel, 2e-3, sv)]))

        s0 = start.replace(pos=start.pos.clone())
        s0.pos[11, 1, 0] = float("nan")
        before = dense_frame.form_launches["global"]
        ks = frames(s0, arr, gid, gpos, dense.step_frame)
        nan_launches = dense_frame.form_launches["global"] - before
        rs = frames(s0, arr, gid, gpos, dense.frame_reference)
        masks = all(torch.equal(torch.isnan(getattr(k, a)),
                                torch.isnan(getattr(r, a)))
                    for k, r in zip(ks, rs) for a in keys)
        rest = all(torch.equal(getattr(k, a)[..., 1:], getattr(g, a)[..., 1:])
                   for k, g in zip(ks, got) for a in keys)
        body0 = bool(torch.isnan(ks[-1].pos[..., 0]).all())
        print(f"phase 27 {name} B={b}: a NaN in particle 11 of body 0: "
              f"{nan_launches} launches for {WIDE_FRAMES} frames, the twin's "
              f"NaN masks after each frame {masks}, body 0 all NaN {body0}, "
              f"the other bodies bitwise the clean run {rest}", flush=True)
        check(masks and rest and body0 and nan_launches == WIDE_FRAMES,
              f"phase 27 {name}: a NaN spreads otherwise than in the twin")

        # the plan's cluster bitwise one block, clean and with a NaN, an inf
        for what, plant in (("clean", None), ("a NaN in body 0", float("nan")),
                            ("an inf in body 0", float("inf"))):
            s1 = start.replace(pos=start.pos.clone())
            if plant is not None:
                s1.pos[11, 1, 0] = plant
            wide, one = (frames(s1, arr, gid, gpos, at_cluster(c))
                         for c in (cs, 1))
            same = all(same_bits(getattr(x, a), getattr(y, a))
                       for x, y in zip(wide, one) for a in keys)
            print(f"phase 27 {name} B={b}, {what}: the cluster of {cs} "
                  f"blocks bitwise one block after each of {WIDE_FRAMES} "
                  f"frames, NaN masks equal, {same}", flush=True)
            check(same, f"phase 27 {name} B={b}: cs={cs} differs from cs=1 "
                  f"({what})")

        k_ms = event_ms(lambda: dense.step_frame(start, arr, params, gid,
                                                 gpos), 20)
        one_ms = event_ms(lambda: at_cluster(1)(start, arr, params, gid,
                                                gpos), 20)
        p_ms = event_ms(lambda: dense.frame_reference(start, arr, params, gid,
                                                      gpos), 1)
        b_ms, b_by = bound(dense_frame.frame_flops(arr, params, b),
                           dense_frame.frame_bytes(arr, b))
        print(f"phase 27 [{label}] {name} B={b}: {k_ms:.4f} ms per frame by "
              f"CUDA events (global form, cluster of {cs} blocks), "
              f"{one_ms:.4f} ms on one block a body; bound "
              f"{b_ms * 1e3:.3f} us ({b_by}, {b_ms / k_ms:.2%} of it); the "
              f"twin {p_ms:.1f} ms per frame", flush=True)
        return err, (k_ms, p_ms, b_ms, b_by, cs)

    # the user's path: World -> add_body_batch(backend="dense"), a grab
    tets = tt.replicate_mesh(single_tet_mesh(), 4843, jitter=1.0, seed=3)
    errs, row = [], None
    for b in WIDE_BS:
        world = tt.World(tt.default_cpu_params())
        body = world.add_body_batch(tets, b, engine="neohookean",
                                    backend="dense", jitter=0.5)
        check(type(body) is DenseBody, "backend='dense' is not DenseBody")
        if b > 5:
            pid = body.start_grab(5, body.positions()[5].mean(axis=0))
            body.move_grabbed(5, body.positions()[5, pid]
                              + np.float32([0.0, 0.05, 0.0]))
        start = body.state
        reset()
        got = []
        with no_host_sync():
            for _ in range(WIDE_FRAMES):
                world.step(1)
                got.append(body.state)
        launches = dict(dense_frame.form_launches)
        clusters = dict(dense_frame.cluster_launches)
        if b > 5:
            check(torch.equal(got[-1].pos[pid, :, 5], body.grab_pos[:, 5]),
                  "grab off target")
        err, times = case(
            "replicate_mesh(single_tet_mesh(), 4843) through World",
            body.arrays, start, body.grab_id, body.grab_pos, got, launches,
            clusters)
        errs.append(err)
        if row is None:  # the row's numbers: B = 8
            row, main_launches = times, launches["global"]
        del world, body, got

    cubes = tt.replicate_mesh(tt.grid_mesh(1, 1, 1, cell=0.1), 2422,
                              jitter=1.0, seed=4)
    arr = dense.build_dense_arrays(cubes, max_bytes=5_000_000_000,
                                   device="cuda")
    for b in WIDE_BS:
        start = dense.init_dense_state(cubes, b, jitter=0.5, seed=1,
                                       device="cuda")
        gid, gpos = dense_grab(start, b)
        vars(arr).pop("onehot", None)  # the last batch's twin built it
        reset()
        with no_host_sync():
            got = frames(start, arr, gid, gpos, dense.step_frame)
        err, _ = case("replicate_mesh(grid_mesh(1, 1, 1), 2422) through "
                      "dense.step_frame", arr, start, gid, gpos, got,
                      dict(dense_frame.form_launches),
                      dict(dense_frame.cluster_launches))
        errs.append(err)
    k_ms, p_ms, b_ms, b_by, cs = row
    return {"name": "dense_frame_global", "route": "cuda",
            "source": "tetsim_torch/kernels/csrc/dense_frame.cu",
            "replaces": "none: the XLA engine (tetsim_tpu/solvers/dense.py:184)",
            "launches": main_launches, "max_abs_err": max(errs),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "cluster": cs}


def sync():
    torch.cuda.synchronize()


@contextlib.contextmanager
def no_host_sync():
    """Stepping must not wait for the device: any synchronising CUDA call
    inside the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def no_grab(b):
    return (torch.full((b, 1), -1, dtype=torch.int32, device="cuda"),
            torch.zeros((b, 1, 3), device="cuda"))


PEAK_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it) at the data sheet's
    peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stamp() -> str:
    """The UTC date and time, as ``date -u +%FT%TZ`` prints it."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def phase(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{label}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def build_all(kernels):
    """Every kernel, one nvcc per source, all started together;
    ``kernels`` maps each source's name to its module."""
    def one(module):
        t0 = time.perf_counter()
        module.library()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        secs = dict(zip(kernels, pool.map(one, kernels.values())))
    for name in kernels:
        print(f"phase 1 build: csrc/{name}.cu with nvcc (sm_90a) in "
              f"{secs[name]:.2f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import tetsim_torch as tt
    from tetsim_torch import roofline
    from tetsim_torch.kernels import (dense_frame, gs_fused, gs_levels,
                                      gs_ordered, nh_pieces, nh_stencil,
                                      polar_fused, polar_jacobi, polar_pieces,
                                      polar_stencil)

    t_start = time.perf_counter()
    print(f"chip_smoke started {stamp()}", flush=True)
    label = card()
    print(label, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    kernels = {"gs_frame": gs_fused, "polar_frame": polar_fused,
               "polar_stencil": polar_stencil, "nh_stencil": nh_stencil,
               "polar_pieces": polar_pieces, "nh_pieces": nh_pieces,
               "gs_ordered": gs_ordered, "extract_rotation": roofline,
               "gs_levels": gs_levels, "polar_jacobi": polar_jacobi,
               "dense_frame": dense_frame}
    phase("phase 1 done", build_all, kernels)

    dragon = tt.load_dragon()
    params = tt.default_cpu_params()
    err = max(phase("phase 2-3 kernel vs plain done", kernel_vs_plain, tt,
                    gs_fused, dragon, params),
              phase("phase 3 contact done", contact_vs_plain, tt, gs_fused,
                    dragon, params))
    launches, _ = phase("phase 4 done", main_path, tt, gs_fused, dragon)
    times = phase("phase 5 done", timings, tt, gs_fused, dragon, label)
    k_ms, p_ms = times["B=1 ordered"]
    ordered = tt.build_arrays(dragon, coloring="ordered", device="cuda")
    gs_bound, gs_by = bound(gs_fused.frame_flops(ordered, params, 1),
                            gs_fused.frame_bytes(ordered, params, 1, 1))

    polar_err = phase("phase 6 done", polar_vs_plain, tt, polar_fused, dragon)
    polar_launches = phase("phase 7 done", polar_main_path, tt, polar_fused,
                           gs_fused, dragon)
    ptimes = phase("phase 8 done", polar_timings, tt, polar_fused, dragon, label)
    pk_ms, pp_ms = ptimes["B=1 Body"]
    gpu = tt.default_gpu_params()
    polar_arr = tt.build_arrays(dragon, coloring=None, device="cuda")
    polar_bound, polar_by = bound(polar_fused.frame_flops(polar_arr, gpu, 1),
                                  polar_fused.frame_bytes(polar_arr, 1, 1))

    grid_err = {m: phase(f"phase 9 {m.__name__.split('.')[-1]} done",
                         grid_vs_plain, tt, m)
                for m in (polar_stencil, nh_stencil)}
    grid_launches = phase("phase 10 done", grid_main_path, tt, kernels)
    grid_times = {m: phase(f"phase 11 {m.__name__.split('.')[-1]} done",
                           grid_timings, tt, m, label)
                  for m in (polar_stencil, nh_stencil)}
    engines = pieces_engines()
    blob, big = phase("phase 12 full-width blob and schedules built",
                      full_width_pieces, tt, engines)
    pieces_err = {e: phase(f"phase 12 {e.name} done", pieces_vs_plain, tt, e,
                           blob, big[e.name])
                  for e in engines}
    phase("phase 12 refusal done", pieces_refusal, tt, engines[0])
    pieces_launches = {e: phase(f"phase 13 {e.name} done", pieces_main_path,
                                tt, e, blob, big[e.name], kernels)
                       for e in engines}
    pieces_times = {e: phase(f"phase 14 {e.name} done", pieces_timings, tt, e,
                             blob, big[e.name], label)
                    for e in engines}
    ordered_err, ordered_plain_ms = phase(
        "phase 15 done", ordered_vs_plain, tt, gs_ordered, gs_fused, dragon)
    ordered_launches, ordered_ms = phase(
        "phase 16 done", ordered_main_path, tt, gs_ordered, gs_fused, dragon)
    phase("phase 17 done", viewer_on_card, tt, gs_ordered, polar_fused, dragon)
    er_err, er_launches, er_ms, er_plain_ms, gbps = phase(
        "phase 18 done", extract_rotation_vs_plain, roofline)
    large = phase("phase 19 done", large_bodies, tt, kernels)
    levels_err = phase("phase 19 gs_levels batches done", levels_batches, tt,
                       gs_levels)
    large[gs_levels] = (large[gs_levels][0],
                        max(large[gs_levels][1], levels_err))
    jacobi_err = phase("phase 19 polar_jacobi batches done", jacobi_batches,
                       tt, polar_jacobi)
    large[polar_jacobi] = (large[polar_jacobi][0],
                           max(large[polar_jacobi][1], jacobi_err))
    phase("phase 20 done", flat_nh_batch, tt, gs_fused, dragon)
    k4a_launches, k4a_err = phase("phase 21 done", polar_slabs, tt,
                                  polar_stencil)
    k3s_launches, k3s_err = phase("phase 22 done", nh_slabs, tt, nh_stencil)
    slab_times = phase("phase 23 slabs done", slab_timings, tt, polar_stencil,
                       nh_stencil, label)
    large_times = phase("phase 23 large bodies done", large_timings, tt,
                        label)
    phase("phase 24 done", sharded_batches, tt, gs_fused, polar_fused, dragon,
          label)
    phase("phase 25 done", tet_axis, tt, dragon, label)
    phase("phase 26 done", surface, tt, gs_fused, polar_fused, polar_stencil,
          dragon)
    dense_row, global_row, dense_bodies, dense_times = phase(
        "phase 27 done", dense_engine, tt, dense_frame, dragon, label)
    phase("phase 28 done", traced, tt, dragon, params, dense_bodies,
          dense_times, label)
    sched = gs_ordered.build_ordered_schedule(dragon)
    ordered_bound, ordered_by = bound(
        gs_ordered.frame_flops(sched, params, 8),
        gs_ordered.frame_bytes(sched, 8, 1))
    lanes = roofline.M_ROWS * 128
    er_bound, er_by = bound(roofline.extract_rotation_flops(lanes),
                            (9 + 4) * 4 * lanes)
    er_rate = roofline.extract_rotation_flops(lanes) / (er_ms * 1e-3)
    print(f"phase 18 measured beside the data sheet: copy {gbps:.1f} GB/s "
          f"({gbps * 1e9 / PEAK_BYTES:.1%} of 3,350), extract_rotation "
          f"{er_rate / 1e12:.3f} TFLOP/s counted ({er_rate / PEAK_FLOPS:.1%} "
          "of 67)", flush=True)
    print(f"bounds at the data sheet's peaks (67 TFLOP/s FP32, 3.35 TB/s): "
          f"gs_frame ordered B=1 frame {gs_bound * 1e3:.3f} us ({gs_by}), "
          f"polar_frame B=1 frame at 20 substeps {polar_bound * 1e3:.3f} us "
          f"({polar_by}), "
          + ", ".join(f"{m.__name__.split('.')[-1]} 56^3 substep "
                      f"{t[2][0] * 1e3:.3f} us ({t[2][1]})"
                      for m, t in grid_times.items())
          + ", " + ", ".join(f"{e.name} 987k substep {t[2][0] * 1e3:.3f} us "
                             f"({t[2][1]})" for e, t in pieces_times.items())
          + f", gs_ordered 8 dragons frame {ordered_bound * 1e3:.3f} us "
          f"({ordered_by}), extract_rotation pass {er_bound * 1e3:.3f} us "
          f"({er_by})"
          + ", " + ", ".join(
              f"{m.__name__.split('.')[-1]} slab form 56^3 substep "
              f"{t[2][0] * 1e3:.3f} us ({t[2][1]})"
              for m, t in slab_times.items())
          + ", " + ", ".join(
              f"{m.__name__.split('.')[-1]} {LARGE} frame "
              f"{t[2][0] * 1e3:.3f} us ({t[2][1]})"
              for m, t in large_times.items())
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)
    grid_lines = [
        {"name": m.__name__.split(".")[-1], "route": "cuda",
         "source": f"tetsim_torch/kernels/csrc/{m.__name__.split('.')[-1]}.cu",
         "replaces": f"tetsim_tpu/kernels/{src}",
         "launches": grid_launches[m], "max_abs_err": grid_err[m],
         "ms": grid_times[m][0], "plain_ms": grid_times[m][1],
         "bound_ms": grid_times[m][2][0], "bound_by": grid_times[m][2][1],
         "library_ms": None}
        for m, src in ((nh_stencil, "nh_stencil.py:265"),
                       (polar_stencil, "polar_stencil.py:137"))]
    pieces_lines = [
        {"name": e.name, "route": "cuda",
         "source": f"tetsim_torch/kernels/csrc/{e.name}.cu",
         "replaces": f"tetsim_tpu/kernels/{e.replaces}",
         "launches": pieces_launches[e], "max_abs_err": pieces_err[e],
         "ms": pieces_times[e][0], "plain_ms": pieces_times[e][1],
         "bound_ms": pieces_times[e][2][0], "bound_by": pieces_times[e][2][1],
         "library_ms": None}
        for e in reversed(engines)]
    slab_lines = [
        {"name": f"{m.__name__.split('.')[-1]}_slabs", "route": "cuda",
         "source": f"tetsim_torch/kernels/csrc/{m.__name__.split('.')[-1]}.cu",
         "replaces": f"tetsim_tpu/kernels/{src}", "launches": n,
         "max_abs_err": e, "ms": slab_times[m][0],
         "plain_ms": slab_times[m][1], "bound_ms": slab_times[m][2][0],
         "bound_by": slab_times[m][2][1], "library_ms": None}
        for m, src, n, e in (
            (nh_stencil, "nh_stencil.py:596", k3s_launches, k3s_err),
            (polar_stencil, "polar_stencil.py:358", k4a_launches, k4a_err))]
    large_lines = [
        {"name": m.__name__.split(".")[-1], "route": "cuda",
         "source": f"tetsim_torch/kernels/csrc/{m.__name__.split('.')[-1]}.cu",
         "replaces": "none: the XLA engine", "launches": large[m][0],
         "max_abs_err": large[m][1], "ms": large_times[m][0],
         "plain_ms": large_times[m][1], "bound_ms": large_times[m][2][0],
         "bound_by": large_times[m][2][1], "library_ms": None}
        for m in (gs_levels, polar_jacobi)]
    print(json.dumps({"kernels": [
        {"name": "gs_frame", "route": "cuda",
         "source": "tetsim_torch/kernels/csrc/gs_frame.cu",
         "replaces": "tetsim_tpu/kernels/gs_fused.py:133",
         "launches": launches, "max_abs_err": err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": gs_bound,
         "bound_by": gs_by, "library_ms": None},
        {"name": "polar_frame", "route": "cuda",
         "source": "tetsim_torch/kernels/csrc/polar_frame.cu",
         "replaces": "tetsim_tpu/kernels/polar_fused.py:171",
         "launches": polar_launches, "max_abs_err": polar_err,
         "ms": pk_ms, "plain_ms": pp_ms, "bound_ms": polar_bound,
         "bound_by": polar_by, "library_ms": None},
    ] + grid_lines + pieces_lines + [
        {"name": "gs_ordered", "route": "cuda",
         "source": "tetsim_torch/kernels/csrc/gs_ordered.cu",
         "replaces": "tetsim_tpu/kernels/gs_ordered.py:161",
         "launches": ordered_launches, "max_abs_err": ordered_err,
         "ms": ordered_ms, "plain_ms": ordered_plain_ms,
         "bound_ms": ordered_bound, "bound_by": ordered_by, "library_ms": None},
        {"name": "extract_rotation", "route": "cuda",
         "source": "tetsim_torch/kernels/csrc/extract_rotation.cu",
         "replaces": "scripts/roofline.py:86",
         "launches": er_launches, "max_abs_err": er_err,
         "ms": er_ms, "plain_ms": er_plain_ms,
         "bound_ms": er_bound, "bound_by": er_by, "library_ms": None},
    ] + slab_lines + large_lines + [dense_row, global_row]}), flush=True)
    print(f"chip_smoke finished {stamp()}, "
          f"{time.perf_counter() - t_start:.1f} s after it started",
          flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
