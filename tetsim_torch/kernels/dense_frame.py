"""One frame of the dense Neo-Hookean engine as one launch
(``csrc/dense_frame.cu``): B bodies of one mesh in columns, every substep's
predict, colour levels, collide, grab and velocity update.

Replaces no TPU kernel: the JAX package runs the frame as XLA's scan of
one-hot products around ``_solve_level_planes``
(``tetsim_tpu/solvers/dense.py``).  The kernel gathers and scatters each
level's corners by index (``DenseArrays.ids``) and gives the bits of the
products, NaN and inf spread included.  ``dense_frame`` launches it on CUDA
tensors and raises on any other; its plain twin is ``solvers/dense.py``'s
``frame_reference`` (the products with ``dense_level_reference`` as the
level solve), which ``solvers.dense.step_frame`` runs on CPU tensors.
``launch_count`` counts the launches, one per frame, ``form_launches``
the launches of each form and ``cluster_launches`` the global form's
launches at each cluster size.

The form is the host's plan from the body's size (``launch_plan``), not a
fallback: a body of up to 19,370 particles runs on a block, its positions
in the block's shared memory (the shared form, 12 bytes a particle against
a Hopper block's 232,448); a larger one on a thread-block cluster of
``cluster`` blocks, its positions in a global scratch that ``dense_frame``
allocates (the global form, no dynamic shared memory): three planes [B, 3,
N] on one block, 12 N B bytes; a float4 [B, N] past it, 16 N B bytes.
The cluster is the largest power of two up to 16 at which the
batch's clusters run at once on the card (``polar_fused.cluster_size`` over
this kernel's ``active_clusters``), capped at the fewest blocks that take a
level's slots in one pass of THREADS each (``cluster_cap``): past that a
block more shortens no level and adds to every cluster barrier.  A launch
that fails raises, naming its form and cluster; none retries at another
cluster or in the other form.  Nothing else bounds N but int32 indexing:
the kernel holds a particle id and a thread's particle index in an int, so
N must stay below 2^31 - 256; long before that the twin's one-hot, f32
[L, N, 4C], meets ``build_dense_arrays``' ``max_bytes`` gate (2 GB by
default, as in the JAX package).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..params import PhysicsParams
from . import build
from .batch import SMEM_LIMIT, expect, prepared
from .gs_fused import _FrameParams, _frame_params
from .polar_fused import CLUSTER_SIZES, MAX_CLUSTER, cluster_size

THREADS = 256  # threads per block, as kThreads in csrc/dense_frame.cu
FLOPS_PER_TET = 421  # one tet's projection, as gs_fused.frame_flops counts it
FLOPS_PER_PARTICLE = 13  # predict and velocity update, per substep
# a tet's row of the level tables: ids, inverse rest pose, inverse rest
# volume and the corners' inverse masses
TABLE_BYTES_PER_TET = 4 * 4 + 9 * 4 + 4 + 4 * 4
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

FORMS = ("shared", "global")

launch_count = 0  # launches of the CUDA kernel since import (or reset)
form_launches = dict.fromkeys(FORMS, 0)  # the launches of each form
# the global form's launches at each cluster size (blocks a body)
cluster_launches = dict.fromkeys(CLUSTER_SIZES, 0)


def smem_bytes(num_particles: int) -> int:
    """The shared form's dynamic shared memory: the body's three position
    planes."""
    return 12 * num_particles


def check_fits(num_particles: int) -> None:
    need = smem_bytes(num_particles)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the shared form of the dense frame kernel keeps a body's "
            f"positions in shared memory: {num_particles} particles need "
            f"{need} bytes, a Hopper block has {SMEM_LIMIT} (at most "
            f"{SMEM_LIMIT // 12} particles)")


class LaunchPlan(NamedTuple):
    form: str  # "shared" or "global": where a body's positions live
    blocks: int  # in all: cluster blocks a body, times the bodies
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block
    scratch_bytes: int  # the global form's positions, all bodies
    cluster: int  # blocks per body (the shared form: 1)


def scratch_bytes(num_bodies: int, num_particles: int, cs: int) -> int:
    """The global form's positions: three f32 planes a body on one block,
    a float4 a particle on a cluster."""
    return num_bodies * num_particles * (12 if cs == 1 else 16)


def cluster_cap(num_slots: int) -> int:
    """The most blocks a body's cluster takes for levels of ``num_slots``
    slots: the fewest (a power of two up to MAX_CLUSTER) at which each
    block takes its ceil(num_slots / cs) slots in one pass of THREADS."""
    cs = 1
    while cs < MAX_CLUSTER and -(-num_slots // cs) > THREADS:
        cs *= 2
    return cs


def launch_plan(num_bodies: int, num_particles: int, num_slots: int,
                form: Optional[str] = None, waves: Optional[dict] = None,
                cs: Optional[int] = None) -> LaunchPlan:
    """A frame's launch: a block per body with its positions in shared
    memory where they fit a block, else a cluster per body with its
    positions in a global scratch.  ``form`` forces one (``chip_smoke.py``
    holds the two against each other); a forced shared form that does not
    fit raises ValueError.  The global form's cluster: ``cs`` where given
    (the card's checks), else ``cluster_size`` under
    ``cluster_cap(num_slots)``, ``waves[cs]`` the clusters of cs blocks the
    card runs at once (``active_clusters``; by default one block per
    SM)."""
    if form is None:
        form = "shared" if smem_bytes(num_particles) <= SMEM_LIMIT else "global"
    if form == "shared":
        if cs is not None:
            raise ValueError("cs sets the global form's cluster; the shared "
                             "form runs a block per body")
        check_fits(num_particles)
        return LaunchPlan(form, num_bodies, THREADS,
                          smem_bytes(num_particles), 0, 1)
    if form == "global":
        if cs is None:
            cs = cluster_size(num_bodies, cluster_cap(num_slots), waves)
        return LaunchPlan(form, num_bodies * cs, THREADS, 0,
                          scratch_bytes(num_bodies, num_particles, cs), cs)
    raise ValueError(f"unknown form {form!r}: expected one of {FORMS}")


def frame_flops(arr, params: PhysicsParams, num_bodies: int) -> int:
    """Floating-point operations of one frame: ``FLOPS_PER_TET`` per tet
    (valid slot) and ``FLOPS_PER_PARTICLE`` per particle, each substep and
    body (compares, clamps, selects and the data-dependent ground friction
    are not counted)."""
    tets = int((arr.irv != 0).sum())
    return num_bodies * params.num_substeps * (
        FLOPS_PER_TET * tets + FLOPS_PER_PARTICLE * arr.num_particles)


def frame_bytes(arr, num_bodies: int) -> int:
    """Bytes a frame must move: pos and vel read once and pos, prev and vel
    written once (f32 [N, 3] a body each), a grab read per body (id and
    target), the level tables' valid slots read once (the kernel skips the
    padded ones)."""
    tets = int((arr.irv != 0).sum())
    return (num_bodies * (5 * 12 * arr.num_particles + 16)
            + TABLE_BYTES_PER_TET * tets)


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its arguments declared."""
    lib = build.load("dense_frame", NVCC_FLAGS)
    if lib.dense_frame_launch.argtypes is None:
        lib.dense_frame_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
            + [_FrameParams, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.dense_frame_launch.restype = ctypes.c_int
        lib.dense_frame_prepare.argtypes = [ctypes.c_int]
        lib.dense_frame_prepare.restype = ctypes.c_int
        lib.dense_frame_prepare_global.restype = ctypes.c_int
        lib.dense_frame_active_clusters.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.dense_frame_active_clusters.restype = ctypes.c_int
        lib.dense_frame_error_string.argtypes = [ctypes.c_int]
        lib.dense_frame_error_string.restype = ctypes.c_char_p
        lib.dense_frame_threads.restype = ctypes.c_int
        if lib.dense_frame_threads() != THREADS:
            raise RuntimeError("csrc/dense_frame.cu kThreads != "
                               "dense_frame.THREADS")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"dense_frame {what} failed: "
                           f"{lib.dense_frame_error_string(err).decode()}")


def active_clusters(device) -> dict:
    """{cs: clusters of cs blocks of the global form the card runs at once}
    for each cluster size (cudaOccupancyMaxActiveClusters on ``device``,
    after the kernel's attributes are set there; 0 where it runs none),
    asked once per library and device.  Raises on a CUDA error."""
    lib = library()
    waves = lib.__dict__.setdefault("waves", {})
    if device.index not in waves:
        out = {}
        with torch.cuda.device(device):
            _check(lib, lib.dense_frame_prepare_global(), "prepare (global "
                   "form)")
            for cs in CLUSTER_SIZES:
                count = ctypes.c_int(0)
                _check(lib, lib.dense_frame_active_clusters(
                    cs, ctypes.byref(count)),
                    f"occupancy query (global form, cs={cs})")
                out[cs] = count.value
        waves[device.index] = out
    return waves[device.index]


def dense_frame(pos, vel, arr, params: PhysicsParams, grab_id, grab_pos, *,
                form: Optional[str] = None, cs: Optional[int] = None):
    """One frame on the card: pos / vel f32 [N, 3, B], grab_id int32 [B] (-1
    inactive), grab_pos f32 [3, B], ``arr`` a ``DenseArrays`` (its tables
    only: the one-hot is the twin's); returns new (pos, prev_pos, vel)
    tensors.  ``form`` forces the launch plan's form and ``cs`` the global
    form's cluster (for the card's checks; by default ``launch_plan`` picks
    both).  Raises on tensors off CUDA and where a launch fails."""
    global launch_count
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the dense frame kernel runs on CUDA, not {dev}")
    N, _, B = pos.shape
    L, C = arr.irv.shape
    f32 = torch.float32
    expect(pos, "pos", f32, (N, 3, B), dev)
    expect(vel, "vel", f32, (N, 3, B), dev)
    expect(grab_id, "grab_id", torch.int32, (B,), dev)
    expect(grab_pos, "grab_pos", f32, (3, B), dev)
    expect(arr.ids, "ids", torch.int32, (L, 4 * C), dev)
    expect(arr.irp, "irp", f32, (L, 9, C), dev)
    expect(arr.irv, "irv", f32, (L, C), dev)
    expect(arr.imc, "imc", f32, (L, 4, C), dev)

    lib = library()
    waves = active_clusters(dev)
    plan = launch_plan(B, N, C, form, waves, cs)
    if waves.get(plan.cluster, 0) < 1:
        raise ValueError(
            f"dense_frame {plan.form} form, cs={plan.cluster}: the card runs "
            f"clusters of {[c for c, n in waves.items() if n >= 1]} blocks")
    pos_out, prev_out, vel_out = (torch.empty_like(pos) for _ in range(3))
    planes = (torch.empty(plan.scratch_bytes // 4, dtype=f32, device=dev)
              if plan.form == "global" else None)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = (0 if plan.form == "global"  # no dynamic shared memory
               else prepared(lib, "dense_frame", dev, N))
        if err == 0:
            err = lib.dense_frame_launch(
                pos.data_ptr(), vel.data_ptr(), pos_out.data_ptr(),
                prev_out.data_ptr(), vel_out.data_ptr(), arr.ids.data_ptr(),
                arr.irp.data_ptr(), arr.irv.data_ptr(), arr.imc.data_ptr(),
                grab_id.data_ptr(), grab_pos.data_ptr(), N, B, L, C,
                params.num_substeps, _frame_params(params),
                None if planes is None else planes.data_ptr(), plan.cluster,
                torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, f"launch ({plan.form} form, cs={plan.cluster}, B={B})")
    launch_count += 1
    form_launches[plan.form] += 1
    if plan.form == "global":
        cluster_launches[plan.cluster] += 1
    return pos_out, prev_out, vel_out
