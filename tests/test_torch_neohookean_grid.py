"""tetsim_torch's structured-grid Neo-Hookean engine
(solvers/neohookean_grid.py, the plain twin of the stencil kernels in
kernels/nh_stencil.py) vs tetsim_tpu's XLA stencil engine on the same
inputs, made with numpy from fixed seeds.

The tables are equal exactly.  A frame from a shared state is held to the
bounds of tests/test_nh_stencil.py: 2e-5 on positions, 2e-3 on velocities,
and 1e-5 on the per-substep volume error.  The JAX engine is compiled once
for the (4, 3, 2) box in its table-driven scan form (bit-identical to the
unrolled sweep, tests/test_neohookean_grid.py) at O0, and once more for
one substep of a second box."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_tpu.solvers import neohookean_grid as jnhg
from tetsim_torch.kernels import nh_stencil
from tetsim_torch.solvers import get_engine, neohookean_grid as tnhg
from tetsim_torch.world import Body, PackedGridBody

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

DIMS = (4, 3, 2)
BOX = dict(cell=0.25, origin=(-0.3, 0.6, -0.3))
PINS = [0, 13]
_O0 = {"xla_backend_optimization_level": "0"}


@pytest.fixture(scope="module")
def xla():
    """The JAX engine's frame at 5 substeps, compiled once for DIMS."""
    mesh = ts.grid_mesh(*DIMS, **BOX)
    arr = jnhg.build_nh_grid_arrays(mesh, DIMS)
    return (jax.jit(lambda s, a, p, c: jnhg.step_frame(s, a, p, c,
                                                       color_scan=True))
            .lower(ts.init_state(mesh), arr, ts.default_cpu_params(),
                   ts.Controls.none())
            .compile(_O0))


def _state(mesh, seed):
    rng = np.random.RandomState(seed)
    s = ts.init_state(mesh)
    return s.replace(vel=rng.uniform(-0.4, 0.4, s.vel.shape).astype(np.float32))


def _to_torch(s):
    return convert.state_from_numpy(*(np.asarray(x) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)), "cpu")


def _controls(grab, target):
    if grab is None:
        return ts.Controls.none(), tt.Controls.none("cpu")
    return (ts.Controls(grab_id=np.int32(grab), grab_pos=target),
            tt.Controls(grab_id=torch.tensor(grab, dtype=torch.int32),
                        grab_pos=torch.as_tensor(target)))


def _assert_close(js, ts_):
    np.testing.assert_allclose(ts_.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(ts_.prev_pos.numpy(), np.asarray(js.prev_pos),
                               atol=2e-5)
    np.testing.assert_allclose(ts_.vel.numpy(), np.asarray(js.vel), atol=2e-3)


@pytest.mark.parametrize("dims", [DIMS, (5, 4, 3)])
def test_nh_grid_arrays_match_jax(dims):
    """Decoded corners, rest pose, masses (flat and in parity blocks) with
    pins, the colour plan, the block layout and its particle ids, the cube
    masks and the per-tet colouring: equal exactly."""
    jm, tm = ts.grid_mesh(*dims, **BOX), tt.grid_mesh(*dims, **BOX)
    ja = jnhg.build_nh_grid_arrays(jm, dims, density=800.0, pinned=PINS)
    ta = tnhg.build_nh_grid_arrays(tm, dims, density=800.0, pinned=PINS,
                                   device="cpu")
    for f in ("dims", "corner_slab", "inv_rest_pose", "inv_rest_volume",
              "rest_volume"):
        assert getattr(ta, f) == getattr(ja, f), f
    for f in ("inv_mass_blocks", "inv_mass"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    assert tnhg._geometry(dims) == jnhg._geometry(dims)
    plan = tnhg._color_plan(ta)
    assert plan == jnhg._color_plan(ja) and len(plan) == 48
    np.testing.assert_array_equal(tnhg._block_pid(dims).numpy(),
                                  np.asarray(jnhg._block_pid(dims)))
    for _, _, _, cw in plan[:8]:
        np.testing.assert_array_equal(tnhg._cube_mask(cw, dims).numpy(),
                                      np.asarray(jnhg._cube_mask(cw, dims)))
    np.testing.assert_array_equal(tnhg.grid_coloring(dims),
                                  jnhg.grid_coloring(dims))
    x = np.arange(ta.num_particles, dtype=np.float32) * 0.5 - 3.0
    blocks = tnhg._to_blocks(torch.as_tensor(x), dims)
    np.testing.assert_array_equal(blocks.numpy(), jnhg._to_blocks_np(x, dims))
    np.testing.assert_array_equal(tnhg._from_blocks(blocks, dims).numpy(), x)
    back = convert.nh_grid_arrays_from_numpy("cpu", **{
        f.name: (np.asarray(getattr(ja, f.name))
                 if f.name.startswith("inv_mass") else getattr(ja, f.name))
        for f in dataclasses.fields(ja)})
    assert back.inv_rest_pose == ta.inv_rest_pose
    assert torch.equal(back.inv_mass_blocks, ta.inv_mass_blocks)


@pytest.mark.parametrize("case", ["drop", "pins_and_grab"])
def test_frame_matches_xla_engine(xla, case):
    """One frame from seeded velocities; with pins and a grab the pinned
    particles stay and the grabbed one is at its target."""
    jm, tm = ts.grid_mesh(*DIMS, **BOX), tt.grid_mesh(*DIMS, **BOX)
    pins = PINS if case == "pins_and_grab" else None
    grab = 29 if case == "pins_and_grab" else None
    target = (jm.verts[29] + np.float32([0.02, 0.05, -0.01])).astype(np.float32)
    ja = jnhg.build_nh_grid_arrays(jm, DIMS, pinned=pins)
    ta = tnhg.build_nh_grid_arrays(tm, DIMS, pinned=pins, device="cpu")
    jc, tc = _controls(grab, target)
    js = _state(jm, seed=1)
    ts_, td = tnhg.step_frame(_to_torch(js), ta, tt.default_cpu_params(), tc)
    js, jd = xla(js, ja, ts.default_cpu_params(), jc)
    _assert_close(js, ts_)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    if case == "pins_and_grab":
        np.testing.assert_array_equal(ts_.pos[PINS].numpy(), jm.verts[PINS])
        np.testing.assert_array_equal(ts_.pos[29].numpy(), target)


def test_second_box_substep_matches_jax():
    """A (5, 4, 3) box with a pin and a grab, one substep of the JAX engine
    (compiled as the module's frame is)."""
    dims = (5, 4, 3)
    jm, tm = ts.grid_mesh(*dims, **BOX), tt.grid_mesh(*dims, **BOX)
    ja = jnhg.build_nh_grid_arrays(jm, dims, pinned=[2])
    ta = tnhg.build_nh_grid_arrays(tm, dims, pinned=[2], device="cpu")
    target = (jm.verts[40] + np.float32([0.0, 0.03, 0.0])).astype(np.float32)
    jc, tc = _controls(40, target)
    js = _state(jm, seed=2)
    params = tt.default_cpu_params()
    ts_, terr = tnhg.substep(_to_torch(js), ta, params, params.dt, tc)
    jp = ts.default_cpu_params()
    js, jerr = (jax.jit(lambda s, a, p, dt, c: jnhg.substep(
        s, a, p, dt, c, color_scan=True))
        .lower(js, ja, jp, jp.dt, jc).compile(_O0)(js, ja, jp, jp.dt, jc))
    _assert_close(js, ts_)
    assert float(terr) == pytest.approx(float(jerr), abs=1e-5)


@pytest.mark.parametrize("engine,packed", [
    ("neohookean_grid", False), ("neohookean_grid_pallas", False),
    ("neohookean_grid_pallas", True)])
def test_world_add_grid_body_matches_jax(xla, engine, packed):
    """World(device="cpu").add_grid_body against the JAX World's grid body
    stepped by the XLA engine: a frame, then from the JAX state a grab near
    particle 29 and a frame; positions 2e-5 and the diagnostics."""
    jw = ts.World(ts.default_cpu_params())
    tw = tt.World(tt.default_cpu_params(), device="cpu")
    kw = dict(cell=0.25, origin=BOX["origin"], pinned=[0])
    jb = jw.add_grid_body(DIMS, engine="neohookean_grid", **kw)
    tb = tw.add_grid_body(DIMS, engine=engine, packed=packed, **kw)
    assert isinstance(tb, PackedGridBody if packed else Body)
    jp = ts.default_cpu_params()

    def step():
        jb.state, jb.last_diag = xla(jb.state, jb.arrays, jp, jb.controls)
        tw.step(1)

    step()
    np.testing.assert_allclose(tb.positions, jb.positions, atol=2e-5)
    tb.state = _to_torch(jb.state)
    point = jb.positions[29] + np.float32([0.0, 1e-3, 0.0])
    assert jb.start_grab(point) == tb.start_grab(point) == 29
    target = point + np.float32([0.0, 0.05, 0.02])
    jb.move_grabbed(target)
    tb.move_grabbed(target)
    step()
    _assert_close(jb.state, tb.state)
    np.testing.assert_array_equal(tb.positions[29], target.astype(np.float32))
    jd, td = jw.diagnostics()["body0"], tw.diagnostics()["body0"]
    assert not td["nan"]
    for k in ("volume_error", "min_height"):
        assert td[k] == pytest.approx(jd[k], abs=2e-5), k
    for k in ("kinetic_energy", "max_speed"):
        assert td[k] == pytest.approx(jd[k], rel=1e-3), k
    # the XLA engine's mean det F - 1 from neohookean_grid, none from the
    # kernel's name
    if engine == "neohookean_grid":
        assert td["solver_vol_error"] == pytest.approx(
            jd["solver_vol_error"], abs=1e-5)
    else:
        assert "solver_vol_error" not in td


def test_packed_body_round_trip_and_dt_change():
    """PackedGridBody (neohookean_grid_pallas): pack/unpack is exact and a
    dt change between steps gives the Body path's numbers."""
    world = tt.World(tt.default_cpu_params(), device="cpu")
    packed = world.add_grid_body((3, 2, 2), engine="neohookean_grid_pallas",
                                 packed=True, cell=0.2, origin=(0, 0.3, 0))
    body = world.add_grid_body((3, 2, 2), engine="neohookean_grid", cell=0.2,
                               origin=(0, 0.3, 0))
    s = _to_torch(_state(ts.grid_mesh(3, 2, 2, cell=0.2, origin=(0, 0.3, 0)),
                         seed=4))
    packed.state = s
    body.state = s
    for f in ("pos", "prev_pos", "vel"):
        assert torch.equal(getattr(packed.state, f), getattr(s, f)), f
    for p in (tt.PhysicsParams(num_substeps=1), tt.PhysicsParams(num_substeps=2)):
        packed.step(p)
        body.step(p)
    for f in ("pos", "prev_pos", "vel"):
        assert torch.equal(getattr(packed.state, f), getattr(body.state, f)), f
    assert body.last_diag.shape == (2,) and packed.last_diag is None


def test_grid_body_batch_matches_single_bodies():
    """GridBodyBatch (neohookean_grid): each box, one grabbed, is the
    single Body of the same box from the same state, vol_err too."""
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    batch = world.add_grid_body_batch((2, 3, 2), 2, cell=0.2,
                                      engine="neohookean_grid")
    start = batch.states
    target = batch.positions[0, 7] + np.float32([0.0, 0.05, 0.0])
    batch.set_grab(0, 7, target)
    world.step(1)
    for b in range(2):
        single = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
        body = single.add_grid_body((2, 3, 2), cell=0.2,
                                    engine="neohookean_grid")
        body.state = tt.SimState(*(getattr(start, f)[b] for f in (
            "pos", "prev_pos", "vel", "quats")))
        if b == 0:
            body.controls = tt.Controls(
                grab_id=torch.tensor(7, dtype=torch.int32),
                grab_pos=torch.as_tensor(target))
        single.step(1)
        np.testing.assert_allclose(batch.positions[b], body.positions,
                                   atol=1e-6)
        np.testing.assert_allclose(batch.last_diag[b].numpy(),
                                   body.last_diag.numpy(), atol=1e-7)
    assert world.diagnostics()["body0"]["batch"] == 2


def test_kernel_module_refusals_and_work_counts():
    """The kernel wrapper refuses a CPU tensor (the plain path is taken
    before it), the engine name maps to the kernel module, and the bound's
    inputs at the 56^3 box: about 446 MFLOP per substep."""
    assert get_engine("neohookean_grid_pallas") is nh_stencil
    small = tnhg.build_nh_grid_arrays(tt.grid_mesh(1, 1, 1), (1, 1, 1),
                                      device="cpu")
    with pytest.raises(ValueError, match="run on CUDA"):
        nh_stencil._grid_frame_cuda(torch.zeros(1, 3, 8), None, small,
                                    tt.PhysicsParams(), None, None, False)
    arr = dataclasses.replace(small, dims=(56, 56, 56))
    one = tt.PhysicsParams(num_substeps=1)
    flops = nh_stencil.frame_flops(arr, one, 1)
    assert flops == 421 * 1_053_696 + 13 * 185_193
    assert 4.4e8 < flops < 4.5e8
    assert nh_stencil.frame_bytes(arr, one, 1, 1) == (
        60 * 185_193 + 4 + 16 + 4 * 185_193)
