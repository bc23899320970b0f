"""Roofline accounting for the grid kernels on the card (counterpart of
``scripts/roofline.py``):

    python -m tetsim_torch.roofline      # one CUDA card; prints one JSON line

  * ``hbm_copy_gbps``        — the streaming ceiling: y = x * c over 256 MB
                               of f32, read and write bytes counted.
  * ``extract_rotation``     — Müller's 9-iteration extract_rotation alone
                               over 1,048,576 lanes, two ways: in the
                               micro-kernel ``kernels/csrc/extract_rotation.cu``
                               (planes in registers, no memory traffic per
                               pass: the floor the polar kernels sit on;
                               ``extract_rotation_kernel_ms``) and as its
                               plain-torch twin, one eager op per step with
                               every intermediate in device memory
                               (``extract_rotation_xla_ms``, the key the JAX
                               package gives its unfused number), and their
                               ratio ``kernel_fusion_gap_x``.
  * per-kernel sections      — ms per substep of the 56^3 box (1,053,696
                               tets) on K3 (``nh_stencil``) and K4
                               (``polar_stencil``) through their packed
                               steppers, the packed state's bytes, the time
                               to stream that state once at the measured copy
                               rate, and the ratios to these floors.

Every time is a two-point fit over two run lengths, each run ending in a
data-dependent device-to-host transfer, the best of three.  Without CUDA
``main`` prints no result and returns 1.

``extract_rotation`` is the module's kernel entry point: on CUDA tensors it
launches the micro-kernel, on CPU tensors it runs
``extract_rotation_reference``, the plain twin.  ``launch_count`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time

import numpy as np
import torch

from .kernels import build
from .kernels.batch import expect
from .solvers.polar_grid import EXTRACT_ITERS, _extract_rotation

N = 56  # 56^3 cubes = 1,053,696 tets / 185,193 particles
M_ROWS = 8192  # 8192 x 128 = 1,048,576 lanes, about the 56^3 box's tets
FLOPS_PER_ITER = 136  # one extract_rotation iteration, as polar_fused counts
NVCC_FLAGS = ()  # the library's own nvcc flags (profile_frame.py adds some)

launch_count = 0  # launches of the micro-kernel since import (or reset)


def library() -> ctypes.CDLL:
    """The micro-kernel's library, built at first use."""
    lib = build.load("extract_rotation", NVCC_FLAGS)
    if lib.extract_rotation_launch.argtypes is None:
        lib.extract_rotation_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.extract_rotation_launch.restype = ctypes.c_int
        lib.extract_rotation_error_string.argtypes = [ctypes.c_int]
        lib.extract_rotation_error_string.restype = ctypes.c_char_p
    return lib


def _extract_rotation_cuda(a, passes: int):
    global launch_count
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the extract_rotation kernel runs on CUDA, not {dev}")
    shape = tuple(a.shape)
    if len(shape) < 2 or shape[0] != 9:
        raise ValueError(f"a: expected [9, ...] planes, got {list(shape)}")
    expect(a, "a", torch.float32, shape, dev)
    lanes = int(np.prod(shape[1:]))
    q = torch.empty((4,) + shape[1:], dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.extract_rotation_launch(
            a.data_ptr(), q.data_ptr(), lanes, passes, EXTRACT_ITERS,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("extract_rotation launch failed: "
                           f"{lib.extract_rotation_error_string(err).decode()}")
    launch_count += 1
    return q


def extract_rotation_reference(a, passes: int):
    """The plain twin: ``passes`` times the grid engine's extract_rotation
    (9 iterations) from the identity on the planes a [9, ...] (a[3 r + c] =
    a[r][c]), then a00 += qw * 1e-20; returns the last pass's quaternion
    planes [4, ...]."""
    planes = list(a.unbind(0))
    q = [torch.zeros_like(planes[0])] * 4
    for _ in range(passes):
        q = _extract_rotation([planes[3 * r:3 * r + 3] for r in range(3)])
        planes[0] = planes[0] + q[3] * np.float32(1e-20)
    return torch.stack(q)


def extract_rotation(a, passes: int):
    """``passes`` passes on planes a [9, ...] (see the twin).  CPU tensors
    take the plain twin; any other device launches the kernel or raises."""
    if a.device.type == "cpu":
        return extract_rotation_reference(a, passes)
    return _extract_rotation_cuda(a, passes)


def extract_rotation_flops(lanes: int) -> int:
    """Operations of one pass: ``FLOPS_PER_ITER`` per iteration and lane."""
    return lanes * EXTRACT_ITERS * FLOPS_PER_ITER


def random_planes(m_rows: int = M_ROWS, seed: int = 2, device="cuda"):
    """Covariance planes [9, m_rows, 128], uniform in [0.5, 1.5), from a
    numpy seed."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 1.5, (9, m_rows, 128)).astype(np.float32)
    return torch.as_tensor(a).to(device)


def _two_point(run, k1: int, k2: int, reps: int = 3) -> float:
    """Seconds per unit of ``run(k)`` from runs of k1 and k2 units, each
    ending in a data-dependent transfer, the best of ``reps``."""
    def timed(k):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chk = float(run(k).sum())
            best = min(best, time.perf_counter() - t0)
        if not np.isfinite(chk):
            raise RuntimeError("a timed run gave a non-finite result")
        return best

    timed(k1)  # warm-up
    timed(k2)
    return (timed(k2) - timed(k1)) / (k2 - k1)


def bench_hbm_copy(device="cuda") -> float:
    """GB/s of y = x * c over 256 MB of f32, read + write counted."""
    n = 64 * 1024 * 1024
    x = torch.rand(n, generator=torch.Generator().manual_seed(0)).to(device)

    def run(k):
        a = x
        for _ in range(k):
            a = a * np.float32(1.0000001)
        return a

    return 2 * 4 * n / _two_point(run, 8, 64) / 1e9


def bench_extract_rotation_kernel(a) -> float:
    """ms per 9-iteration pass of the micro-kernel on planes ``a``."""
    return _two_point(lambda k: extract_rotation(a, k), 4, 16) * 1e3


def bench_extract_rotation_plain(a) -> float:
    """ms per pass of the plain twin on planes ``a`` (eager torch)."""
    return _two_point(lambda k: extract_rotation_reference(a, k), 1, 3) * 1e3


def _grid_box(engine: str):
    """The 56^3 box at cell 0.02 and its packed stepper (1 substep)."""
    import tetsim_torch as tt
    from .solvers import get_engine
    from .solvers.neohookean_grid import build_nh_grid_arrays
    from .solvers.polar_grid import build_grid_arrays

    mesh = tt.grid_mesh(N, N, N, cell=0.02, origin=(-0.56, 0.5, -0.56))
    build_fn = (build_nh_grid_arrays if engine.startswith("neohookean")
                else build_grid_arrays)
    arr = build_fn(mesh, (N, N, N), device="cuda")
    params = tt.PhysicsParams(num_substeps=1)
    pack, step, _, _ = get_engine(engine).make_frame_stepper(arr)
    return mesh, params, pack, step


def bench_stencil(engine: str, k1: int = 50, k2: int = 400):
    """(ms per substep, packed state bytes) of a grid kernel at 56^3."""
    import tetsim_torch as tt

    mesh, params, pack, step = _grid_box(engine)
    packed0 = pack(tt.init_state(mesh, "cuda"), params)
    none = tt.Controls.none("cuda")

    def run(k):
        p = packed0
        for _ in range(k):
            p = step(p, params, none)
        return p[0]

    ms = _two_point(run, k1, k2) * 1e3
    state_bytes = sum(x.numel() * x.element_size() for x in packed0
                      if torch.is_tensor(x))
    return ms, state_bytes


def main() -> int:
    if not torch.cuda.is_available():
        print("tetsim_torch.roofline: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0), "mesh": f"{N}^3 cubes",
           "tets": 6 * N * N * N, "particles": (N + 1) ** 3}

    gbps = bench_hbm_copy()
    out["hbm_copy_gbps"] = round(gbps, 1)
    print(f"hbm copy: {gbps:.0f} GB/s", file=sys.stderr, flush=True)

    a = random_planes()
    er_ms = bench_extract_rotation_kernel(a)
    out["extract_rotation_kernel_ms"] = round(er_ms, 4)
    print(f"extract_rotation in the micro-kernel (9 it, {a[0].numel()} "
          f"lanes): {er_ms:.4f} ms", file=sys.stderr, flush=True)
    erp_ms = bench_extract_rotation_plain(a)
    out["extract_rotation_xla_ms"] = round(erp_ms, 3)
    out["kernel_fusion_gap_x"] = round(erp_ms / er_ms, 2)
    print(f"extract_rotation as plain torch ops: {erp_ms:.3f} ms "
          f"({erp_ms / er_ms:.1f}x the micro-kernel)", file=sys.stderr,
          flush=True)

    nh_ms, nh_bytes = bench_stencil("neohookean_grid_pallas")
    nh_floor = 2 * nh_bytes / (gbps * 1e9) * 1e3  # stream the state r+w once
    out["nh_stencil"] = {
        "measured_ms_per_substep": round(nh_ms, 4),
        "state_bytes": nh_bytes,
        "hbm_stream_floor_ms": round(nh_floor, 4),
        "vs_hbm_floor": round(nh_ms / nh_floor, 1),
        "note": "one cooperative launch per frame (predict, 48 colour "
                "phases and collide per substep, a grid barrier between "
                "phases); two XPBD projections per tet and colour",
    }
    print(f"nh_stencil: {nh_ms:.4f} ms/substep (copy floor {nh_floor:.4f} "
          "ms)", file=sys.stderr, flush=True)

    po_ms, po_bytes = bench_stencil("polar_grid_pallas")
    po_floor = 2 * po_bytes / (gbps * 1e9) * 1e3
    out["polar_stencil"] = {
        "measured_ms_per_substep": round(po_ms, 4),
        "state_bytes": po_bytes,
        "hbm_stream_floor_ms": round(po_floor, 4),
        "extract_rotation_floor_ms": round(er_ms, 4),
        "vs_vpu_floor": round(po_ms / er_ms, 2),
        "note": "2 launches per substep; the tet pass runs one "
                "extract_rotation per tet, the micro-kernel's floor",
    }
    print(f"polar_stencil: {po_ms:.4f} ms/substep (extract_rotation floor "
          f"{er_ms:.4f} ms)", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
