"""tetsim_torch's exact-order batch (``kernels/gs_ordered.py``) on the CPU,
held against tetsim_tpu's: the schedule tables, the JAX kernel in Pallas
interpret mode, the sequential golden oracle and the XLA ordered engine.

On the CPU the frame runs ``ordered_frame_reference``, the plain twin of
the CUDA kernel ``kernels/csrc/gs_ordered.cu``; the kernel itself runs only
on the card, where ``chip_smoke.py`` holds it against that twin."""
import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels import gs_ordered as jgo
from tetsim_tpu.solvers.golden import GoldenSolver
from tetsim_torch.kernels import gs_ordered as go

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
GRAB = (2, 5, [0.1, 1.3, 0.0])  # body, particle, target


def _small():
    return tt.grid_mesh(3, 3, 3, **SMALL)


@pytest.mark.parametrize("which, w_lanes", [("small", 256), ("dragon", 384)])
def test_schedule_equals_jax(which, w_lanes):
    """Every table equals the JAX package's first sublane; the dragon packs
    703 sub-levels into 4 windows."""
    jmesh = ts.load_dragon() if which == "dragon" else ts.grid_mesh(3, 3, 3, **SMALL)
    tmesh = tt.load_dragon() if which == "dragon" else _small()
    js = jgo.build_ordered_schedule(jmesh, w_lanes=w_lanes)
    ps = go.build_ordered_schedule(tmesh, w_lanes=w_lanes)
    for k in ("uidx", "xinv"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k)[:, 0], k)
    for k in ("lids", "winv"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k)[:, :, 0], k)
    np.testing.assert_array_equal(ps.cons, js.cons)
    np.testing.assert_array_equal(ps.movw, js.movw[0])
    np.testing.assert_array_equal(ps.nlev, js.nlev[0])
    for k in ("num_windows", "l_max", "w_lanes", "rows", "num_levels"):
        assert getattr(ps, k) == getattr(js, k), k
    if which == "dragon":
        assert (ps.num_windows, ps.num_levels) == (4, 703)
        tab = go.ordered_tables(ps, "cpu")
        assert tuple(tab.sub_ids.shape) == (703, 4, 32)
        # the kernel's flat tables list every tet once, in schedule order
        ids = tab.sub_ids.numpy()
        live = ids[:, 0] >= 0
        assert live.sum() == 3840 and live.sum(axis=1).max() <= 22


@pytest.fixture(scope="module")
def jax_frame():
    """One interpret-mode frame of the JAX kernel: 8 jittered bodies, a
    grab on body 2, 2 substeps."""
    body = jgo.OrderedGSBody(ts.grid_mesh(3, 3, 3, **SMALL), interpret=True,
                             w_lanes=256, jitter=0.05, seed=1)
    body.set_grab(*GRAB)
    body.step(ts.PhysicsParams(num_substeps=2), frames=1)
    return body.positions(), body.velocities()


def test_twin_matches_jax_kernel(jax_frame):
    """Positions 2e-5 and velocities 2e-3 (ROADMAP's ordered-GS bar) after
    one frame; the grabbed particle sits on its target."""
    body = go.OrderedGSBody(_small(), w_lanes=256, jitter=0.05, seed=1,
                            device="cpu")
    body.set_grab(*GRAB)
    count = go.launch_count
    body.step(tt.PhysicsParams(num_substeps=2))
    assert go.launch_count == count  # the CPU never launches the kernel
    pos, vel = body.positions(), body.velocities()
    np.testing.assert_allclose(pos, jax_frame[0], atol=2e-5)
    np.testing.assert_allclose(vel, jax_frame[1], atol=2e-3)
    b, pid, target = GRAB
    np.testing.assert_array_equal(pos[b, pid], np.float32(target))
    assert np.abs(pos[0] - pos[1]).max() > 1e-3  # jittered bodies differ


def test_twin_matches_golden_oracle():
    """The exactness property (tests/test_gs_ordered.py): one frame equals
    the sequential NumPy reference within 2e-5, in every body."""
    params = tt.default_cpu_params()
    body = go.OrderedGSBody(_small(), w_lanes=256, device="cpu")
    body.step(params)
    g = GoldenSolver(ts.grid_mesh(3, 3, 3, **SMALL))
    for _ in range(params.num_substeps):
        g.substep(1.0 / 300.0)
    for b in range(8):
        np.testing.assert_allclose(body.positions()[b], g.pos, atol=2e-5)


def test_twin_matches_xla_ordered_engine():
    """4 frames of 3 substeps against the JAX XLA engine on the ordered
    schedule: 5e-5 (tests/test_gs_ordered.py)."""
    body = go.OrderedGSBody(_small(), w_lanes=256, device="cpu")
    body.step(tt.PhysicsParams(num_substeps=3), frames=4)
    jmesh = ts.grid_mesh(3, 3, 3, **SMALL)
    params = ts.PhysicsParams(num_substeps=3)
    arr = ts.build_arrays(jmesh, coloring="ordered")
    step = jax.jit(ts.get_engine("neohookean").step_frame)
    state = ts.init_state(jmesh)
    for _ in range(4):
        state, _ = step(state, arr, params, ts.Controls.none())
    np.testing.assert_allclose(body.positions()[0], np.asarray(state.pos),
                               atol=5e-5)


def test_world_fused_ordered_backend():
    """add_body_batch(..., backend="fused_ordered"): the JAX package's
    refusals, diagnostics and per-body grabs."""
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    batch = world.add_body_batch(_small(), 8, engine="neohookean",
                                 backend="fused_ordered", jitter=0.05)
    assert isinstance(batch, go.OrderedGSBody) and batch.num_bodies == 8
    pid = batch.start_grab(4, [0.0, 1.0, 0.0])
    batch.move_grabbed(4, [0.0, 1.4, 0.0])
    world.step(2)
    d = world.diagnostics()["body0"]
    assert d["batch"] == 8 and not d["nan"] and d["min_height"] >= -1e-5
    pos = batch.positions()
    np.testing.assert_array_equal(pos[4, pid], np.float32([0.0, 1.4, 0.0]))
    assert np.abs(pos[0] - pos[1]).max() > 1e-3
    batch.end_grab(4)
    assert int(batch.grab_id[4, 0]) == -1
    with pytest.raises(ValueError, match="exactly 8"):
        world.add_body_batch(_small(), 4, engine="neohookean",
                             backend="fused_ordered")
    with pytest.raises(ValueError, match="neohookean"):
        world.add_body_batch(_small(), 8, engine="polar",
                             backend="fused_ordered")
    with pytest.raises(IndexError):
        batch.set_grab(8, 0, [0, 0, 0])


def test_kernel_wrapper_and_bounds():
    """The CUDA wrapper refuses a CPU tensor; the bound's counts for 8
    dragons at 5 substeps (about 0.975 us of operations at 67 TFLOP/s)."""
    body = go.OrderedGSBody(_small(), w_lanes=256, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        go._ordered_frame_cuda(body.pos, body.vel, body.tables,
                               tt.default_cpu_params(), body.grab_id,
                               body.grab_pos)
    sched = go.build_ordered_schedule(tt.load_dragon())
    params = tt.default_cpu_params()
    flops = go.frame_flops(sched, params, 8)
    assert flops == 8 * 5 * (420 * 3840 + 16 * 1234)
    assert abs(flops / 67e12 * 1e6 - 0.975) < 1e-3
    assert go.frame_bytes(sched, 8, 1) == (8 * (5 * 12 * 1234 + 16)
                                           + 72 * 3840 + 4 * 1234)
    assert go.smem_bytes(1234) == 4 * 9 * 1234
    with pytest.raises(ValueError, match="shared memory"):
        go.check_fits(40 ** 3)
    # the kernel's scalars: f32 and the twin's operation order
    fp = go._ordered_params(params)
    assert np.float32(fp.inv_dt) == np.float32(1.0) / params.dt
    assert np.float32(fp.gdt) == params.gravity * params.dt
    assert torch.equal(body.tables.movw, torch.ones(64))
