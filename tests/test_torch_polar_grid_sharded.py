"""tetsim_torch's x-slab polar grid steppers (``solvers/polar_grid.py``
``make_grid_sharded_step``, ``kernels/polar_stencil.py``
``make_grid_sharded_stepper``) on ``SlabMesh(devices=["cpu"] * d)``
against tetsim_tpu's ``make_grid_sharded_step`` on the 8 virtual devices
and against the port's own unsharded engine, on numpy-seeded inputs.

Bars: against JAX those of ``tests/test_torch_polar_grid.py`` (positions
and quaternions 2e-5, velocities 2e-2); against the unsharded engine 2e-6
on positions and quaternions, JAX's own bar for this pair
(``tests/test_polar_stencil.py``), and 2e-6 / dt on velocities, since the
halo only re-associates the boundary planes' sums.  The JAX reference
(about 17 s to compile) runs once per module."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_torch.kernels import polar_stencil
from tetsim_torch.parallel import SlabMesh
from tetsim_torch.solvers import polar_grid as tpg
from tetsim_tpu.solvers import polar_grid as jpg

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

DIMS = (8, 3, 5)
BOX = dict(cell=0.2, origin=(-0.8, 0.5, -0.5))
SUBSTEPS = 4
FRAMES = 2


def _inputs():
    """Seeded velocities and quaternions near identity; a grab on the top
    vertex of global plane x = 4 (shared by slabs 0 and 1 at d = 2)."""
    mesh = ts.grid_mesh(*DIMS, **BOX)
    rng = np.random.RandomState(5)
    s = ts.init_state(mesh)
    vel = rng.uniform(-0.3, 0.3, s.vel.shape).astype(np.float32)
    q = np.asarray(s.quats) + rng.normal(0, 0.05, s.quats.shape)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    gy, gz = DIMS[1] + 1, DIMS[2] + 1
    gid = (4 * gy + gy - 1) * gz + 2
    target = np.float32(mesh.verts[gid] + [0.05, 0.1, 0.0])
    return mesh, s.replace(vel=vel, quats=q), gid, target


def _torch_state(s):
    return convert.state_from_numpy(*(np.asarray(x) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)), "cpu")


def _controls(gid, target):
    return tt.Controls(grab_id=torch.tensor(gid, dtype=torch.int32),
                       grab_pos=torch.as_tensor(target))


def _cpu_mesh(d):
    return SlabMesh(devices=["cpu"] * d)


def _port_arrays():
    return tpg.build_grid_arrays(tt.grid_mesh(*DIMS, **BOX), DIMS,
                                 device="cpu")


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's make_grid_sharded_step over 8 devices: the start state and the
    state after FRAMES frames."""
    mesh, s0, gid, target = _inputs()
    garr = jpg.build_grid_arrays(mesh, DIMS)
    devmesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    slab, sarr = jpg.grid_prepare(s0, garr, devmesh)
    step = jpg.make_grid_sharded_step(devmesh, garr)
    params = ts.PhysicsParams(num_substeps=SUBSTEPS)
    ctl = ts.Controls(grab_id=np.int32(gid), grab_pos=target)
    for _ in range(FRAMES):
        slab, diags = step(slab, sarr, params, ctl)
    return s0, jpg.grid_unprepare(slab, garr, 8), np.asarray(diags)


def _port_sharded(d, s0, gid, target):
    garr = _port_arrays()
    mesh = _cpu_mesh(d)
    slab, sarr = tpg.grid_prepare(_torch_state(s0), garr, mesh)
    step = tpg.make_grid_sharded_step(mesh, garr)
    params = tt.PhysicsParams(num_substeps=SUBSTEPS)
    for _ in range(FRAMES):
        slab, diags = step(slab, sarr, params, _controls(gid, target))
    return slab, tpg.grid_unprepare(slab, garr, d), diags


def test_sharded_step_matches_jax(jax_sharded):
    """8 slabs of one cube column, 2 frames with seeded velocities and a
    grab: positions, prev and quaternions 2e-5, velocities 2e-2, diags 0."""
    s0, js, jdiags = jax_sharded
    _, _, gid, target = _inputs()
    _, got, diags = _port_sharded(8, s0, gid, target)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(got.prev_pos.numpy(), np.asarray(js.prev_pos),
                               atol=2e-5)
    np.testing.assert_allclose(got.quats.numpy(), np.asarray(js.quats),
                               atol=2e-5)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(js.vel), atol=2e-2)
    np.testing.assert_array_equal(diags.numpy(), jdiags)
    np.testing.assert_array_equal(got.pos[gid].numpy(), target)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_matches_unsharded(d):
    """The port's slab form against its own unsharded plain engine, from
    the same seeded state with the grab: positions, prev and quaternions
    2e-6 (JAX's bar for this pair), velocities the same bar over dt (they
    are (pos - prev) / dt)."""
    _, s0, gid, target = _inputs()
    _, got, _ = _port_sharded(d, s0, gid, target)
    garr = _port_arrays()
    ref = _torch_state(s0)
    params = tt.PhysicsParams(num_substeps=SUBSTEPS)
    for _ in range(FRAMES):
        ref, _ = tpg.step_frame(ref, garr, params, _controls(gid, target))
    for f in ("pos", "prev_pos", "quats"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=2e-6)
    torch.testing.assert_close(got.vel, ref.vel, rtol=0,
                               atol=float(2e-6 / params.dt))


def test_grab_on_shared_plane_lands_on_both_replicas():
    """At d = 2 the grabbed vertex lies on the plane both slabs store: both
    copies sit on the target, and every shared plane's copies are equal."""
    _, s0, gid, target = _inputs()
    slab, _, _ = _port_sharded(2, s0, gid, target)
    gy, gz = DIMS[1] + 1, DIMS[2] + 1
    local = gid - 4 * gy * gz  # the same vertex on the right slab's plane 0
    np.testing.assert_array_equal(slab.pos[0][:, gid].numpy(), target)
    np.testing.assert_array_equal(slab.pos[1][:, local].numpy(), target)
    gyz = gy * gz
    for f in ("pos", "prev", "vel"):
        left, right = getattr(slab, f)
        assert torch.equal(left[:, 4 * gyz:], right[:, :gyz]), f


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_prepare_unprepare_exact(d):
    _, s0, _, _ = _inputs()
    state = _torch_state(s0)
    slab, sarr = tpg.grid_prepare(state, _port_arrays(), _cpu_mesh(d))
    assert len(slab.pos) == d and slab.pos[0].shape == (3, (8 // d + 1) * 24)
    assert slab.quats[0].shape == (24, 8 // d * 15)
    back = tpg.grid_unprepare(slab, _port_arrays(), d)
    for f in ("pos", "prev_pos", "vel", "quats"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    garr = _port_arrays()
    assert torch.equal(torch.cat([x[:-24] for x in sarr.den[:-1]]
                                 + [sarr.den[-1]]), garr.den.reshape(-1))


def test_uneven_split_raises():
    garr = tpg.build_grid_arrays(tt.grid_mesh(6, 2, 2, cell=0.2), (6, 2, 2),
                                 device="cpu")
    mesh = _cpu_mesh(4)
    state = tt.init_state(tt.grid_mesh(6, 2, 2, cell=0.2), "cpu")
    for make in (lambda: tpg.make_grid_sharded_step(mesh, garr),
                 lambda: polar_stencil.make_grid_sharded_stepper(mesh, garr),
                 lambda: tpg.grid_prepare(state, garr, mesh)):
        with pytest.raises(ValueError, match="divide evenly"):
            make()


def test_stepper_on_cpu_runs_the_twin():
    """make_grid_sharded_stepper on CPU slabs runs the K4a twin: within 1e-6
    of the XLA form, and no kernel launch is counted."""
    _, s0, gid, target = _inputs()
    garr, mesh = _port_arrays(), _cpu_mesh(4)
    prepare, step, unprepare = polar_stencil.make_grid_sharded_stepper(
        mesh, garr)
    params = tt.PhysicsParams(num_substeps=SUBSTEPS)
    before = polar_stencil.acc_launch_count
    packed = prepare(_torch_state(s0), params)
    for _ in range(FRAMES):
        packed = step(packed, params, _controls(gid, target))
    got = unprepare(packed, params)
    _, want, _ = _port_sharded(4, s0, gid, target)
    for f in ("pos", "prev_pos", "vel", "quats"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=1e-6)
    assert polar_stencil.acc_launch_count == before


def test_slab_mesh_defaults_to_the_card():
    """SlabMesh(d) asks for the card; the CPU mesh groups its slabs."""
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.groups() == [(torch.device("cpu"), 0, 3)]
    with pytest.raises(ValueError):
        SlabMesh()
    if torch.cuda.is_available():
        assert SlabMesh(2).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SlabMesh(2)


def test_slab_mesh_moves_and_groups():
    """The moves between neighbours: copies one way each, the halo's adds
    leave both copies of a shared plane equal to the same sum; ``place``
    lays a group's slabs out as one buffer that ``group_view`` reuses."""
    from tetsim_torch.parallel.slabs import group_view, plane

    mesh = _cpu_mesh(3)
    rng = np.random.RandomState(9)
    slabs = mesh.place([torch.as_tensor(rng.normal(size=(3, 12)).astype(
        np.float32)) for _ in range(3)])
    whole = group_view(slabs)
    assert whole.data_ptr() == slabs[0].data_ptr() and whole.shape == (3, 3, 12)
    assert torch.equal(group_view([s.clone() for s in slabs]), whole)
    lo = [plane(s, 0, 4) for s in slabs]
    hi = [plane(s, 2, 4) for s in slabs]
    before = [s.clone() for s in slabs]
    mesh.add_halo(lo, hi)
    for i in range(2):  # hi of slab i and lo of slab i + 1: one sum
        assert torch.equal(hi[i], lo[i + 1])
        assert torch.equal(hi[i], plane(before[i], 2, 4)
                           + plane(before[i + 1], 0, 4))
    assert torch.equal(lo[0], plane(before[0], 0, 4))
    assert torch.equal(hi[2], plane(before[2], 2, 4))
    mesh.send_left(lo, hi)  # plane lx <- the right neighbour's plane 0
    assert torch.equal(hi[1], lo[2]) and torch.equal(hi[0], lo[1])
