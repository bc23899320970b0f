"""tetsim_torch's structured-grid polar engine (solvers/polar_grid.py, the
plain twin of the stencil kernel in kernels/polar_stencil.py) vs
tetsim_tpu's XLA stencil engine on the same inputs, made with numpy from
fixed seeds.

The tables are equal exactly.  The trajectories are held to the bounds of
tests/test_polar_stencil.py: 2e-5 on positions and quaternions, 2e-2 on
velocities, after 2 frames at 4 substeps.  The JAX engine is compiled once
for the (4, 3, 2) box (odd dims stress the phantom lanes), at O0 as
tests/test_nh_stencil.py compiles; a second box is held to the port's
generic polar engine."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_tpu.solvers import polar_grid as jpg
from tetsim_torch.kernels import polar_stencil
from tetsim_torch.solvers import get_engine, polar_grid as tpg
from tetsim_torch.world import Body, GridBodyBatch, PackedGridBody

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

DIMS = (4, 3, 2)
BOX = dict(cell=0.25, origin=(-0.5, 0.4, -0.3))
PINS = [0, 11]
_O0 = {"xla_backend_optimization_level": "0"}


@pytest.fixture(scope="module")
def xla():
    """The JAX engine's frame at 4 substeps, compiled once for DIMS."""
    mesh = ts.grid_mesh(*DIMS, **BOX)
    arr = jpg.build_grid_arrays(mesh, DIMS)
    return (jax.jit(jpg.step_frame)
            .lower(ts.init_state(mesh), arr, ts.PhysicsParams(num_substeps=4),
                   ts.Controls.none())
            .compile(_O0))


def _state(mesh, seed):
    """Rest positions with seeded velocities, quaternions near identity."""
    rng = np.random.RandomState(seed)
    s = ts.init_state(mesh)
    vel = rng.uniform(-0.4, 0.4, s.vel.shape).astype(np.float32)
    q = np.asarray(s.quats) + rng.normal(0, 0.05, s.quats.shape)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return s.replace(vel=vel, quats=q)


def _to_torch(s):
    return convert.state_from_numpy(*(np.asarray(x) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)), "cpu")


def _controls(grab, target):
    if grab is None:
        return ts.Controls.none(), tt.Controls.none("cpu")
    return (ts.Controls(grab_id=np.int32(grab), grab_pos=target),
            tt.Controls(grab_id=torch.tensor(grab, dtype=torch.int32),
                        grab_pos=torch.as_tensor(target)))


def _assert_close(js, ts_, pos=2e-5, quat=2e-5, vel=2e-2):
    np.testing.assert_allclose(ts_.pos.numpy(), np.asarray(js.pos), atol=pos)
    np.testing.assert_allclose(ts_.prev_pos.numpy(), np.asarray(js.prev_pos),
                               atol=pos)
    np.testing.assert_allclose(ts_.quats.numpy(), np.asarray(js.quats),
                               atol=quat)
    np.testing.assert_allclose(ts_.vel.numpy(), np.asarray(js.vel), atol=vel)


@pytest.mark.parametrize("dims", [DIMS, (3, 2, 4)])
def test_grid_arrays_match_jax(dims):
    """Decoded corners, rest shapes, masses and scatter weights, with pins,
    and the flat geometry and phantom mask: equal exactly."""
    jm, tm = ts.grid_mesh(*dims, **BOX), tt.grid_mesh(*dims, **BOX)
    ja = jpg.build_grid_arrays(jm, dims, density=800.0, pinned=PINS)
    ta = tpg.build_grid_arrays(tm, dims, density=800.0, pinned=PINS,
                               device="cpu")
    for f in ("dims", "corner_slab", "slab_offsets", "rest_centered",
              "rest_volume"):
        assert getattr(ta, f) == getattr(ja, f), f
    for f in ("inv_mass", "den"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    assert tpg._flat_geometry(ta) == jpg._flat_geometry(ja)
    np.testing.assert_array_equal(tpg._cube_valid_mask(ta).numpy(),
                                  np.asarray(jpg._cube_valid_mask(ja)))
    assert (ta.num_particles, ta.num_tets) == (ja.num_particles, ja.num_tets)
    back = convert.grid_arrays_from_numpy("cpu", **{
        f.name: (np.asarray(getattr(ja, f.name))
                 if f.name in ("inv_mass", "den") else getattr(ja, f.name))
        for f in dataclasses.fields(ja)})
    assert back.rest_centered == ta.rest_centered
    assert torch.equal(back.den, ta.den)
    with pytest.raises(ValueError, match="not a grid_mesh"):
        tpg.build_grid_arrays(tm, (dims[0] + 1,) + dims[1:], device="cpu")


def test_quaternion_math_matches_jax():
    """The component-wise helpers on seeded inputs; extract_rotation at 9
    and at 3 iterations: 1e-6."""
    rng = np.random.RandomState(3)
    q = rng.normal(size=(2, 4, 64)).astype(np.float32)
    a = (np.eye(3, dtype=np.float32)[:, :, None]
         + rng.normal(0, 0.2, (3, 3, 64)).astype(np.float32))
    v = (0.1, -0.2, 0.05)
    t = torch.as_tensor
    pairs = [(tpg._qrot_const(v, *t(q[0])), jpg._qrot_const(v, *q[0])),
             (tpg._qmul(*t(q[0]), *t(q[1])), jpg._qmul(*q[0], *q[1]))]
    for iters in (9, 3):
        pairs.append((tpg._extract_rotation([[t(x) for x in r] for r in a],
                                            iters),
                      jpg._extract_rotation([list(r) for r in a], iters)))
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("case", ["drop", "pins_and_grab"])
def test_frames_match_xla_engine(xla, case):
    """Two frames at 4 substeps from seeded velocities and quaternions;
    with pins and a grab, the pinned particles stay and the grabbed one is
    at its target."""
    jm, tm = ts.grid_mesh(*DIMS, **BOX), tt.grid_mesh(*DIMS, **BOX)
    pins = PINS if case == "pins_and_grab" else None
    grab = 23 if case == "pins_and_grab" else None
    target = (jm.verts[23] + np.float32([0.02, 0.05, -0.01])).astype(np.float32)
    ja = jpg.build_grid_arrays(jm, DIMS, pinned=pins)
    ta = tpg.build_grid_arrays(tm, DIMS, pinned=pins, device="cpu")
    jc, tc = _controls(grab, target)
    js = _state(jm, seed=1)
    ts_ = _to_torch(js)
    params = tt.PhysicsParams(num_substeps=4)
    for _ in range(2):
        js, jd = xla(js, ja, ts.PhysicsParams(num_substeps=4), jc)
        ts_, td = tpg.step_frame(ts_, ta, params, tc)
        _assert_close(js, ts_)
    assert td.shape == (4,) and not td.any()
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    if case == "pins_and_grab":
        np.testing.assert_array_equal(ts_.pos[PINS].numpy(), jm.verts[PINS])
        np.testing.assert_array_equal(ts_.pos[23].numpy(), target)


def test_second_box_matches_generic_engine():
    """A (3, 2, 4) box with a pin and a grab, one frame at 4 substeps: the
    stencil engine against the port's generic polar engine
    (solvers/polar.py, held to JAX's in tests/test_torch_polar.py) on the
    same mesh, as tests/test_polar_grid.py holds the two JAX engines.  They
    differ only in the order of each particle's sum and in how the axis of
    a rotation step is rounded: 2e-5."""
    dims = (3, 2, 4)
    mesh = tt.grid_mesh(*dims, **BOX)
    ga = tpg.build_grid_arrays(mesh, dims, pinned=[1], device="cpu")
    ta = tt.build_arrays(mesh, coloring=None, pinned=[1], device="cpu")
    target = (mesh.verts[30] + np.float32([0.0, 0.03, 0.0])).astype(np.float32)
    _, tc = _controls(30, target)
    s = _to_torch(_state(ts.grid_mesh(*dims, **BOX), seed=2))
    params = tt.PhysicsParams(num_substeps=4)
    grid, _ = tpg.step_frame(s, ga, params, tc)
    generic, _ = get_engine("polar").step_frame(s, ta, params, tc)
    for f in ("pos", "prev_pos", "quats"):
        np.testing.assert_allclose(getattr(grid, f).numpy(),
                                   getattr(generic, f).numpy(), atol=2e-5)
    np.testing.assert_allclose(grid.vel.numpy(), generic.vel.numpy(),
                               atol=2e-2)
    np.testing.assert_array_equal(grid.pos[30].numpy(), target)


@pytest.mark.parametrize("engine,packed", [
    ("polar_grid", False), ("polar_grid_pallas", False),
    ("polar_grid_pallas", True)])
def test_world_add_grid_body_matches_jax(xla, engine, packed):
    """World(device="cpu").add_grid_body against the JAX World's grid body
    stepped by the XLA engine: a frame, a grab near particle 23, another
    frame; positions 2e-5 and the diagnostics."""
    params = dict(num_substeps=4)
    jw = ts.World(ts.PhysicsParams(**params))
    tw = tt.World(tt.PhysicsParams(**params), device="cpu")
    kw = dict(cell=0.25, origin=BOX["origin"], pinned=[0])
    jb = jw.add_grid_body(DIMS, engine="polar_grid", **kw)
    tb = tw.add_grid_body(DIMS, engine=engine, packed=packed, **kw)
    assert isinstance(tb, PackedGridBody if packed else Body)
    jp = ts.PhysicsParams(**params)

    def step():
        jb.state, jb.last_diag = xla(jb.state, jb.arrays, jp, jb.controls)
        tw.step(1)

    step()
    point = jb.positions[23] + np.float32([0.0, 1e-3, 0.0])
    assert jb.start_grab(point) == tb.start_grab(point) == 23
    target = point + np.float32([0.0, 0.05, 0.02])
    jb.move_grabbed(target)
    tb.move_grabbed(target)
    step()
    np.testing.assert_allclose(tb.positions, jb.positions, atol=2e-5)
    np.testing.assert_array_equal(tb.positions[23], target.astype(np.float32))
    _assert_close(jb.state, tb.state)
    jd, td = jw.diagnostics()["body0"], tw.diagnostics()["body0"]
    assert not td["nan"]
    for k in ("volume_error", "min_height"):
        assert td[k] == pytest.approx(jd[k], abs=2e-5), k
    for k in ("kinetic_energy", "max_speed"):
        assert td[k] == pytest.approx(jd[k], rel=1e-3), k
    # 0 per substep from polar_grid, NaN (left out) from the kernel's name
    assert ("solver_vol_error" in td) == (engine == "polar_grid")
    tb.end_grab()
    assert int(tb.controls.grab_id) == -1


def test_packed_body_round_trip_dt_change_and_reset():
    """PackedGridBody: pack/unpack is exact, a dt change between steps
    gives the Body path's numbers, reset returns to the start."""
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    packed = world.add_grid_body((3, 2, 2), engine="polar_grid_pallas",
                                 packed=True, cell=0.2, origin=(0, 0.3, 0))
    body = world.add_grid_body((3, 2, 2), engine="polar_grid", cell=0.2,
                               origin=(0, 0.3, 0))
    start = packed.state
    s = _to_torch(_state(ts.grid_mesh(3, 2, 2, cell=0.2, origin=(0, 0.3, 0)),
                         seed=4))
    packed.state = s
    body.state = s
    for f in ("pos", "prev_pos", "vel", "quats"):
        assert torch.equal(getattr(packed.state, f), getattr(s, f)), f
    for p in (tt.PhysicsParams(num_substeps=2), tt.PhysicsParams(num_substeps=3)):
        packed.step(p)
        body.step(p)
    for f in ("pos", "prev_pos", "vel", "quats"):
        assert torch.equal(getattr(packed.state, f), getattr(body.state, f)), f
    assert torch.equal(packed.pos_device(), body.state.pos)
    assert packed.last_diag is None
    packed.reset()
    assert torch.equal(packed.state.pos, start.pos)


def test_grid_body_batch_matches_single_bodies():
    """GridBodyBatch (polar_grid): each box of the batch, one grabbed, is
    the single Body of the same box from the same state."""
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    batch = world.add_grid_body_batch((2, 2, 3), 3, cell=0.2)
    assert isinstance(batch, GridBodyBatch)
    start = batch.states
    target = batch.positions[1, 5] + np.float32([0.0, 0.05, 0.02])
    batch.set_grab(1, 5, target)
    world.step(2)
    for b in range(3):
        single = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
        body = single.add_grid_body((2, 2, 3), cell=0.2)
        body.state = tt.SimState(*(getattr(start, f)[b] for f in (
            "pos", "prev_pos", "vel", "quats")))
        if b == 1:
            body.controls = tt.Controls(
                grab_id=torch.tensor(5, dtype=torch.int32),
                grab_pos=torch.as_tensor(target))
        single.step(2)
        np.testing.assert_allclose(batch.positions[b], body.positions,
                                   atol=1e-6)
        np.testing.assert_allclose(batch.states.quats[b].numpy(),
                                   body.state.quats.numpy(), atol=1e-6)
    np.testing.assert_array_equal(batch.positions[1, 5], target)
    assert batch.last_diag.shape == (3, 2)
    d = world.diagnostics()["body0"]
    assert d["batch"] == 3 and not d["nan"]
    pid = batch.start_grab(2, [1.2, 0.5, 0.0])
    assert batch.grab_particle(2 * batch.mesh.num_particles + pid,
                               [1.2, 0.9, 0.0]) == 2
    batch.end_grab(2)
    with pytest.raises(IndexError):
        batch.end_grab(3)
    with pytest.raises(ValueError, match="render surface"):
        batch.surface_mesh()
    surf = world.add_grid_body_batch((2, 2, 3), 2, cell=0.2, with_surface=True)
    verts, _, tris = surf.surface_mesh()
    m = surf.mesh  # each surface vertex is one corner of its tet
    w = np.concatenate([m.vis_bary, 1 - m.vis_bary.sum(1, keepdims=True)], 1)
    pids = m.tets[m.vis_tet_ids, w.argmax(1)]
    np.testing.assert_array_equal(verts[m.num_surface_verts:],
                                  surf.positions[1][pids])
    assert tris.shape == (2 * len(m.tris), 3)


def test_grid_engines_registered_and_refusals():
    for name in ("polar_grid", "polar_grid_pallas", "neohookean_grid",
                 "neohookean_grid_pallas"):
        eng = get_engine(name)
        assert hasattr(eng, "step_frame") and hasattr(eng, "substep"), name
    assert get_engine("polar_grid_pallas") is polar_stencil
    world = tt.World(device="cpu")
    mesh = tt.grid_mesh(*DIMS)
    with pytest.raises(ValueError, match="stencil arrays"):
        world.add_body(mesh, engine="polar_grid")
    surf = world.add_grid_body(DIMS, with_surface=True)
    verts, normals, tris = surf.surface_mesh()
    assert verts.shape == (surf.mesh.num_surface_verts, 3) and len(tris)
    assert np.isfinite(normals).all()
    with pytest.raises(ValueError, match="fused kernel engine"):
        world.add_grid_body(DIMS, engine="polar_grid", packed=True)
    with pytest.raises(ValueError, match="stencil engines"):
        world.add_grid_body(DIMS, engine="polar")
    with pytest.raises(ValueError, match="stencil engines"):
        world.add_grid_body_batch(DIMS, 2, engine="polar_grid_pallas")
    arr = tpg.build_grid_arrays(mesh, DIMS, device="cpu")
    with pytest.raises(ValueError, match="runs on CUDA"):
        polar_stencil._grid_frame_cuda(
            torch.zeros(1, 3, arr.num_particles), None, None, arr,
            tt.PhysicsParams(), None, None)


def test_grid_entry_points_default_to_cuda():
    """Without device= the grid entry points ask for the card; on a host
    without CUDA they raise rather than run on the CPU."""
    makers = (lambda: tt.World().add_grid_body(DIMS),
              lambda: GridBodyBatch(DIMS, 2))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_frame_work_counts():
    """The bound's inputs at the 56^3 box: 1,053,696 tets, 185,193
    particles, about 1.70 GFLOP per substep."""
    small = tpg.build_grid_arrays(tt.grid_mesh(1, 1, 1), (1, 1, 1),
                                  device="cpu")
    arr = dataclasses.replace(small, dims=(56, 56, 56))
    assert (arr.num_tets, arr.num_particles) == (1_053_696, 185_193)
    one = tt.PhysicsParams(num_substeps=1)
    flops = polar_stencil.frame_flops(arr, one, 1)
    assert flops == 1_053_696 * (391 + 136 * 9 + 12) + 19 * 185_193
    assert 1.69e9 < flops < 1.72e9
    assert polar_stencil.frame_bytes(arr, 1, 1) == (
        60 * 185_193 + 32 * 1_053_696 + 16 + 8 * 185_193)
