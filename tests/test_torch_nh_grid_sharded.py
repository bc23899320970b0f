"""tetsim_torch's x-slab Neo-Hookean grid steppers
(``solvers/neohookean_grid.py`` ``make_nh_sharded_step``,
``kernels/nh_stencil.py`` ``make_nh_sharded_stepper``) on
``SlabMesh(devices=["cpu"] * d)`` against tetsim_tpu's
``make_nh_sharded_step`` and against the port's own unsharded engine, on
numpy-seeded inputs.

Bars: against JAX those of ``tests/test_torch_neohookean_grid.py``
(positions 2e-5, velocities 2e-3, diagnostics 1e-5); against the unsharded
engine bitwise, since the exchanges only refresh replicas and every tet's
arithmetic is the same.  The JAX reference (the colour-scan form at O0,
about 30 s to compile) runs once per module."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_torch.kernels import nh_stencil
from tetsim_torch.parallel import SlabMesh
from tetsim_torch.solvers import neohookean_grid as tnhg
from tetsim_tpu.solvers import neohookean_grid as jnhg

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

_O0 = {"xla_backend_optimization_level": "0"}


def _inputs(dims, cell, origin, seed, grab):
    """Rest positions with seeded velocities and a grab lifting ``grab``."""
    mesh = ts.grid_mesh(*dims, cell=cell, origin=origin)
    rng = np.random.RandomState(seed)
    s = ts.init_state(mesh)
    vel = rng.uniform(-0.4, 0.4, s.vel.shape).astype(np.float32)
    target = np.float32(mesh.verts[grab] + [0.02, 0.1, 0.0])
    return mesh, s.replace(vel=vel), grab, target


SMALL = ((4, 2, 2), 0.25, (0.0, 0.5, 0.0), 4, 7)  # vertex 7: plane x = 0
WIDE = ((8, 4, 4), 0.15, (-0.6, 0.5, -0.3), 3, 4 * 25 + 12)  # plane x = 4


def _torch_state(s):
    return convert.state_from_numpy(*(np.asarray(x) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)), "cpu")


def _controls(gid, target):
    return tt.Controls(grab_id=torch.tensor(gid, dtype=torch.int32),
                       grab_pos=torch.as_tensor(target))


def _port_arrays(mesh, dims):
    return tnhg.build_nh_grid_arrays(
        tt.TetMesh(verts=mesh.verts, tets=mesh.tets), dims, device="cpu")


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's make_nh_sharded_step (colour scan, O0) over 2 devices on the
    (4, 2, 2) box, 2 frames: (start, end state, last frame's diags)."""
    mesh, s0, gid, target = _inputs(*SMALL)
    arr = jnhg.build_nh_grid_arrays(mesh, SMALL[0])
    devmesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    step = jnhg.make_nh_sharded_step(devmesh, arr, "x", compiler_options=_O0,
                                     color_scan=True)
    params = ts.PhysicsParams()
    ctl = ts.Controls(grab_id=np.int32(gid), grab_pos=target)
    slab = jnhg.nh_prepare(s0, arr, 2)
    for _ in range(2):
        slab, diags = step(slab, params, ctl)
    return s0, jnhg.nh_unprepare(slab, arr, 2, params), np.asarray(diags)


def _port_sharded(case, d, frames=2):
    mesh, s0, gid, target = _inputs(*case)
    arr = _port_arrays(mesh, case[0])
    slabs = SlabMesh(devices=["cpu"] * d)
    step = tnhg.make_nh_sharded_step(slabs, arr)
    params = tt.PhysicsParams()
    slab = tnhg.nh_prepare(_torch_state(s0), arr, slabs)
    for _ in range(frames):
        slab, diags = step(slab, params, _controls(gid, target))
    return slab, tnhg.nh_unprepare(slab, arr, d, params), diags


def test_sharded_step_matches_jax(jax_sharded):
    """(4, 2, 2) over 2 slabs, 2 frames with seeded velocities and a grab:
    positions 2e-5, velocities 2e-3, the global mean vol_err 1e-5."""
    _, js, jdiags = jax_sharded
    _, got, diags = _port_sharded(SMALL, 2)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(got.prev_pos.numpy(), np.asarray(js.prev_pos),
                               atol=2e-5)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(js.vel), atol=2e-3)
    np.testing.assert_allclose(diags.numpy(), jdiags, atol=1e-5)
    assert diags.shape == (5,) and np.abs(jdiags).max() > 0
    np.testing.assert_array_equal(got.quats.numpy(), np.asarray(js.quats))


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_equals_unsharded_bitwise(d):
    """(8, 4, 4) over 2 and 4 slabs, 2 frames with a grab on a shared plane:
    positions and velocities bit for bit the unsharded plain engine's, and
    the diagnostic its global mean."""
    slab, got, diags = _port_sharded(WIDE, d)
    mesh, s0, gid, target = _inputs(*WIDE)
    arr = _port_arrays(mesh, WIDE[0])
    ref = _torch_state(s0)
    params = tt.PhysicsParams()
    for _ in range(2):
        ref, ref_diag = tnhg.step_frame(ref, arr, params, _controls(gid, target))
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    torch.testing.assert_close(diags, ref_diag, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.pos[gid].numpy(), target)
    gyz = 25
    for i in range(d - 1):  # the shared planes' copies agree
        lx = 8 // d
        assert torch.equal(slab[0][i][:, lx * gyz:], slab[0][i + 1][:, :gyz])


def test_prepare_unprepare():
    """pos and vel come back exactly; prev is pos - vel * dt and the
    quaternions identity, as in the JAX package."""
    mesh, s0, _, _ = _inputs(*WIDE)
    arr = _port_arrays(mesh, WIDE[0])
    state = _torch_state(s0)
    params = tt.PhysicsParams()
    slab = tnhg.nh_prepare(state, arr, SlabMesh(devices=["cpu"] * 4))
    assert len(slab[0]) == 4 and slab[0][0].shape == (3, 3 * 25)
    back = tnhg.nh_unprepare(slab, arr, 4, params)
    assert torch.equal(back.pos, state.pos) and torch.equal(back.vel, state.vel)
    assert torch.equal(back.prev_pos, state.pos - state.vel * params.dt)
    assert torch.equal(back.quats[:, 3], torch.ones(arr.num_tets))


def test_uneven_or_odd_slabs_raise():
    """Odd cube columns per slab, and nx not divisible by d, raise."""
    gm = tt.grid_mesh(6, 2, 2, cell=0.2)
    arr = tnhg.build_nh_grid_arrays(gm, (6, 2, 2), device="cpu")
    state = tt.init_state(gm, "cpu")
    for d, match in ((2, "even"), (4, "divide")):
        mesh = SlabMesh(devices=["cpu"] * d)
        for make in (lambda: tnhg.make_nh_sharded_step(mesh, arr),
                     lambda: nh_stencil.make_nh_sharded_stepper(mesh, arr),
                     lambda: tnhg.nh_prepare(state, arr, mesh)):
            with pytest.raises(ValueError, match=match):
                make()


def test_stepper_on_cpu_runs_the_twin():
    """make_nh_sharded_stepper on CPU slabs runs the K3s twin: bit for bit
    the XLA form, and no kernel launch is counted."""
    mesh, s0, gid, target = _inputs(*WIDE)
    arr = _port_arrays(mesh, WIDE[0])
    slabs = SlabMesh(devices=["cpu"] * 4)
    prepare, step, unprepare = nh_stencil.make_nh_sharded_stepper(slabs, arr)
    params = tt.PhysicsParams()
    before = nh_stencil.segment_launch_count
    packed = prepare(_torch_state(s0), params)
    for _ in range(2):
        packed = step(packed, params, _controls(gid, target))
    got = unprepare(packed, params)
    _, want, _ = _port_sharded(WIDE, 4)
    for f in ("pos", "prev_pos", "vel", "quats"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert nh_stencil.segment_launch_count == before
