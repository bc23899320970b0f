"""tetsim_torch's plain polar engine (solvers/polar.py) vs tetsim_tpu's XLA
polar engine on the same inputs, made with numpy from fixed seeds.

The bounds are the reference's own polar bound (tests/test_polar_fused.py):
2e-5 on positions and quaternions, 2e-2 on velocities.  Both sides are
f32 with the same operation order, but XLA on the CPU contracts multiplies
and adds into FMAs within each fusion and torch rounds every operation, so
the two differ by rounding and are compared over short horizons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_tpu.mesh import replicate_mesh as jreplicate
from tetsim_tpu.solvers import polar as jpolar
from tetsim_tpu.utils import mat3 as jmat3
from tetsim_torch.mesh import build_incidence, replicate_mesh
from tetsim_torch.solvers import polar as tpolar
from tetsim_torch.utils import mat3 as tmat3
from tetsim_torch.world import Body

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # tests/conftest.py small_mesh


def _meshes(name):
    if name == "dragon":
        return ts.load_dragon(), tt.load_dragon()
    return ts.grid_mesh(3, 3, 3, **SMALL), tt.grid_mesh(3, 3, 3, **SMALL)


def _random_rotations(rng, m, max_angle=np.pi):
    """Unit quaternions of m rotations about seeded random axes by angles up
    to ``max_angle``."""
    axis = rng.normal(size=(m, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(0, max_angle, m)[:, None] / 2
    return np.concatenate([axis * np.sin(half), np.cos(half)], 1).astype(np.float32)


@pytest.mark.parametrize("iters", [9, 3])
def test_extract_rotation_matches_jax(iters):
    """Covariances R S of seeded random rotations R and symmetric stretches
    S, from the identity and from a random warm start: 1e-5.  The rotations
    stay within 0.5 rad of either start (a substep's increment is far
    smaller): further out the fixed trip count has not converged, and
    rounding decides where it stops (0.09 apart at 1.5 rad)."""
    rng = np.random.RandomState(5)
    m = 256
    rot = np.asarray(jpolar.quat_to_mat(_random_rotations(rng, m, 0.5)))
    u = rng.normal(0, 0.15, (m, 3, 3)).astype(np.float32)
    stretch = np.eye(3, dtype=np.float32) + 0.5 * (u + u.transpose(0, 2, 1))
    a = np.einsum("mij,mjk->mik", rot, stretch).astype(np.float32)
    ident = np.zeros((m, 4), np.float32)
    ident[:, 3] = 1.0
    for q0 in (ident, _random_rotations(rng, m, 0.5)):
        want = jax.jit(jpolar.extract_rotation, static_argnums=2)(a, q0, iters)
        got = tpolar.extract_rotation(torch.as_tensor(a), torch.as_tensor(q0),
                                      iters)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(6)
    q1, q2 = _random_rotations(rng, 64), _random_rotations(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    a, b = rng.normal(size=(2, 64, 4, 3)).astype(np.float32)
    t = torch.as_tensor
    for got, want in (
        (tpolar.quat_mul(t(q1), t(q2)), jpolar.quat_mul(q1, q2)),
        (tpolar.quat_rotate(t(v), t(q1)), jpolar.quat_rotate(v, q1)),
        (tpolar.quat_to_mat(t(q1)), jpolar.quat_to_mat(q1)),
        (tpolar.quat_normalize(t(q1 * 3.0)), jpolar.quat_normalize(q1 * 3.0)),
        (tmat3.outer_sum(t(a), t(b)), jmat3.outer_sum(a, b)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["dragon", "small"])
def test_incidence_tables_equal(name):
    """build_incidence and build_arrays(coloring=None): every table equal
    to the reference's, bit for bit."""
    ref_mesh, port_mesh = _meshes(name)
    ref = ts.build_arrays(ref_mesh, coloring=None)
    port = tt.build_arrays(port_mesh, coloring=None, device="cpu")
    assert port.slot_tets is None
    for f in ("tets", "inv_mass", "rest_volume", "rest_centered", "inc_idx",
              "inc_den"):
        want, got = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    vol = np.asarray(ref.rest_volume)
    for want, got in zip(ts.mesh.build_incidence(ref_mesh.tets, vol,
                                                 ref_mesh.num_particles),
                         build_incidence(port_mesh.tets, vol,
                                         port_mesh.num_particles)):
        assert want.dtype == got.dtype and np.array_equal(want, got)
    if name == "dragon":
        assert tuple(port.inc_idx.shape) == (1234, 32)
    assert tt.build_arrays(port_mesh, coloring="greedy",
                           device="cpu").inc_idx is None


def test_replicate_mesh_equal():
    ref = jreplicate(ts.load_dragon(), 3, jitter=0.2, seed=4)
    port = replicate_mesh(tt.load_dragon(), 3, jitter=0.2, seed=4)
    for f in ("verts", "tets", "edges", "vis_tet_ids", "vis_bary", "tris"):
        want, got = getattr(ref, f), getattr(port, f)
        assert want.dtype == got.dtype and np.array_equal(want, got), f


def _small_run(frames, substeps, grab=None):
    jm, tm = _meshes("small")
    jarr = ts.build_arrays(jm, coloring=None)
    tarr = tt.build_arrays(tm, coloring=None, device="cpu")
    jc, tc = ts.Controls.none(), tt.Controls.none("cpu")
    if grab is not None:
        jc = ts.Controls(grab_id=np.int32(grab[0]), grab_pos=np.float32(grab[1]))
        tc = tt.Controls(grab_id=torch.tensor(grab[0], dtype=torch.int32),
                         grab_pos=torch.tensor(grab[1], dtype=torch.float32))
    jparams = ts.PhysicsParams(num_substeps=substeps)
    tparams = tt.PhysicsParams(num_substeps=substeps)
    step = jax.jit(ts.get_engine("polar").step_frame)
    js, tsx = ts.init_state(jm), tt.init_state(tm, "cpu")
    for _ in range(frames):
        js, jv = step(js, jarr, jparams, jc)
        tsx, tv = tpolar.step_frame(tsx, tarr, tparams, tc)
    return js, jv, tsx, tv


def test_step_frame_matches_xla():
    """small_mesh, 4 frames x 5 substeps: pos and quats 2e-5, vel 2e-2."""
    js, jv, tsx, tv = _small_run(frames=4, substeps=5)
    assert tv.shape == (5,) and not tv.any()
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(tsx.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(tsx.prev_pos.numpy(), np.asarray(js.prev_pos),
                               atol=2e-5)
    np.testing.assert_allclose(tsx.quats.numpy(), np.asarray(js.quats),
                               atol=2e-5)
    np.testing.assert_allclose(tsx.vel.numpy(), np.asarray(js.vel), atol=2e-2)
    assert np.abs(tsx.pos.numpy() - _meshes("small")[1].verts).max() > 1e-2


def test_step_frame_with_grab_matches_xla():
    """A grab lifting particle 30 by 5 cm: 2 frames x 5 substeps, 2e-5,
    and the grabbed particle sits on its target."""
    target = _meshes("small")[1].verts[30] + np.float32([0.0, 0.05, 0.0])
    js, _, tsx, _ = _small_run(frames=2, substeps=5, grab=(30, target))
    np.testing.assert_allclose(tsx.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(tsx.quats.numpy(), np.asarray(js.quats),
                               atol=2e-5)
    np.testing.assert_array_equal(tsx.pos[30].numpy(), target)


def test_zero_gravity_rest_and_grab():
    """No gravity: the rest shape is a fixed point within 1e-4 over 10
    frames of 20 substeps (tests/test_polar.py); a grab holds its particle
    on its target within 1e-6."""
    mesh = tt.grid_mesh(3, 3, 3, **SMALL)
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    params = tt.PhysicsParams(num_substeps=20, gravity=0.0)
    state = tt.init_state(mesh, "cpu")
    for _ in range(10):
        state, _ = tpolar.step_frame(state, arr, params, tt.Controls.none("cpu"))
    np.testing.assert_allclose(state.pos.numpy(), mesh.verts, atol=1e-4)
    target = torch.tensor([0.1, 1.3, 0.05])
    ctrl = tt.Controls(grab_id=torch.tensor(12, dtype=torch.int32),
                       grab_pos=target)
    for _ in range(3):
        state, _ = tpolar.step_frame(state, arr, tt.PhysicsParams(), ctrl)
    assert (state.pos[12] - target).abs().max() <= 1e-6
    assert torch.isfinite(state.pos).all()


def test_index_add_path_matches_incidence_gather():
    """Without incidence tables the solve sums corners with index_add_; it
    gives the gather's result to rounding."""
    mesh = tt.grid_mesh(3, 3, 3, **SMALL)
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    bare = tt.build_arrays(mesh, coloring="greedy", device="cpu")
    rng = np.random.RandomState(8)
    pos = torch.as_tensor(
        (mesh.verts + rng.normal(0, 0.02, mesh.verts.shape)).astype(np.float32))
    quats = torch.as_tensor(_random_rotations(rng, mesh.num_tets))
    p1, q1 = tpolar.solve_shape_match(pos, quats, arr)
    p2, q2 = tpolar.solve_shape_match(pos, quats, bare)
    torch.testing.assert_close(q1, q2, rtol=0, atol=0)
    torch.testing.assert_close(p1, p2, rtol=0, atol=1e-6)
    assert (p1 - pos).abs().max() > 1e-3


@pytest.fixture(scope="module")
def dragon_mid_fall():
    """The JAX dragon after 3 frames at 20 substeps (default_gpu_params)
    with particle 100 held 10 cm above its rest place, then one more frame
    from there in both packages."""
    mesh = ts.load_dragon()
    arr = ts.build_arrays(mesh, coloring=None)
    params = ts.default_gpu_params()
    target = mesh.verts[100] + np.float32([0.0, 0.1, 0.0])
    ctrl = ts.Controls(grab_id=np.int32(100), grab_pos=target)
    step = jax.jit(ts.get_engine("polar").step_frame)
    state = ts.init_state(mesh)
    for _ in range(3):
        state, _ = step(state, arr, params, ctrl)
    body = Body(tt.load_dragon(), engine="polar", device="cpu")
    body.state = convert.state_from_numpy(*(np.asarray(x) for x in (
        state.pos, state.prev_pos, state.vel, state.quats)), "cpu")
    body.controls = tt.Controls(grab_id=torch.tensor(100, dtype=torch.int32),
                                grab_pos=torch.as_tensor(target))
    state, _ = step(state, arr, params, ctrl)
    body.step(tt.default_gpu_params())
    return state, body


def test_dragon_frame_from_shared_state(dragon_mid_fall):
    state, body = dragon_mid_fall
    assert body.arrays.slot_tets is None and body.arrays.inc_idx is not None
    np.testing.assert_allclose(body.positions, np.asarray(state.pos), atol=2e-5)
    np.testing.assert_allclose(body.state.quats.numpy(), np.asarray(state.quats),
                               atol=2e-5)
    assert body.positions[:, 1].min() > 0.0  # before contact
    assert np.abs(np.asarray(state.quats)[:, :3]).max() > 1e-2


def test_rotated_normals_match_jax(dragon_mid_fall):
    """surface_mesh(normals="rotated") against the JAX package's surface
    export from the same positions and quaternions: 1e-5."""
    from tetsim_tpu.world import _Surface as JaxSurface

    state, body = dragon_mid_fall
    body.state = body.state.replace(
        pos=torch.as_tensor(np.array(state.pos)),
        quats=torch.as_tensor(np.array(state.quats)))
    jv, jn, jt = JaxSurface(ts.load_dragon()).mesh_data(
        state.pos, state.quats, normals="rotated")
    tv, tn, tris = body.surface_mesh(normals="rotated")
    assert tn.shape == (29800, 3)
    np.testing.assert_array_equal(tris, jt)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(tn, jn, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-5)
    sv, sn, _ = body.surface_mesh()
    np.testing.assert_array_equal(sv, tv)
    assert np.abs(sn - tn).max() > 1e-3  # the two shadings differ
