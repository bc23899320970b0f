"""tetsim_torch's bodies too large for one block's shared memory: the plain
twins of ``kernels/gs_levels.py`` and ``kernels/polar_jacobi.py`` against
tetsim_tpu's XLA engines on the same numpy-seeded inputs, and ``Body``'s
choice between the fused frame kernels and these modules.

The twins are held to the bars of ``tests/test_torch_neohookean.py`` /
``tests/test_torch_polar.py``: positions 2e-5, polar quaternions 2e-5,
velocities 2e-2 (polar), vol_err 1e-5."""
import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch.kernels import (gs_fused, gs_levels, polar_fused,
                                  polar_jacobi)
from tetsim_torch.kernels.batch import SMEM_LIMIT

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
MESHES = {"small": ((3, 3, 3), SMALL),
          "grid6": ((6, 6, 6), dict(cell=0.1, origin=(-0.3, 0.2, -0.3)))}


def _meshes(name):
    dims, kw = MESHES[name]
    return ts.grid_mesh(*dims, **kw), tt.grid_mesh(*dims, **kw)


def _seeded(mesh, seed):
    """Positions and velocities perturbed from rest, made with numpy."""
    rng = np.random.RandomState(seed)
    pos = (mesh.verts + rng.normal(0, 0.004, mesh.verts.shape)).astype(np.float32)
    vel = rng.normal(0, 0.3, mesh.verts.shape).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("name", sorted(MESHES))
def test_levels_twin_matches_xla(name):
    """gs_levels' twin on the ordered schedule, 2 frames with a grab,
    against the JAX neohookean engine: pos 2e-5, vol_err 1e-5."""
    jm, tm = _meshes(name)
    pos, vel = _seeded(tm, 1)
    gid, target = 5, tm.verts[5] + np.float32([0.0, 0.04, 0.0])
    jarr = ts.build_arrays(jm, coloring="ordered")
    tarr = tt.build_arrays(tm, coloring="ordered", device="cpu")
    js = ts.init_state(jm).replace(pos=pos, prev_pos=pos, vel=vel)
    jc = ts.Controls(grab_id=np.int32(gid), grab_pos=target)
    jparams, tparams = ts.PhysicsParams(), tt.PhysicsParams()
    step = jax.jit(ts.get_engine("neohookean").step_frame)
    tp, tv = torch.as_tensor(pos)[None], torch.as_tensor(vel)[None]
    tgid = torch.tensor([[gid]], dtype=torch.int32)
    tgpos = torch.as_tensor(target)[None, None]
    for _ in range(2):
        js, jerr = step(js, jarr, jparams, jc)
        tp, _, tv, terr = gs_levels.levels_frame(tp, tv, tarr, tparams, tgid,
                                                 tgpos)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(terr[0].numpy(), np.asarray(jerr), atol=1e-5)
    np.testing.assert_array_equal(tp[0, gid].numpy(), target)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_jacobi_twin_matches_xla(name):
    """polar_jacobi's twin, 2 frames with a grab, against the JAX polar
    engine: pos and quaternions 2e-5, velocities 2e-2."""
    jm, tm = _meshes(name)
    pos, vel = _seeded(tm, 2)
    gid, target = 7, tm.verts[7] + np.float32([0.03, 0.0, 0.0])
    jarr = ts.build_arrays(jm, coloring=None)
    tarr = tt.build_arrays(tm, coloring=None, device="cpu")
    js = ts.init_state(jm).replace(pos=pos, prev_pos=pos, vel=vel)
    jc = ts.Controls(grab_id=np.int32(gid), grab_pos=target)
    jparams, tparams = ts.PhysicsParams(), tt.PhysicsParams()
    step = jax.jit(ts.get_engine("polar").step_frame)
    tp, tv = torch.as_tensor(pos)[None], torch.as_tensor(vel)[None]
    tq = torch.zeros((1, tm.num_tets, 4))
    tq[..., 3] = 1.0
    tgid = torch.tensor([[gid]], dtype=torch.int32)
    tgpos = torch.as_tensor(target)[None, None]
    for _ in range(2):
        js, _ = step(js, jarr, jparams, jc)
        tp, _, tv, tq = polar_jacobi.jacobi_frame(tp, tv, tq, tarr, tparams,
                                                  tgid, tgpos)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(tq[0].numpy(), np.asarray(js.quats), atol=2e-5)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(js.vel), atol=2e-2)


@pytest.mark.parametrize("engine", ["neohookean", "polar"])
def test_body_picks_multi_block_exactly_when_check_fits_fails(engine):
    """Body runs the fused frame kernel where check_fits passes and the
    multi-block module where it raises; the limit is SMEM_LIMIT's."""
    fused, large = ((polar_fused, polar_jacobi) if engine == "polar"
                    else (gs_fused, gs_levels))
    limit = 6_456  # particles of 9 f32 planes (+ a few warp sums) in 227 KB
    assert fused.smem_bytes(limit) <= SMEM_LIMIT < fused.smem_bytes(limit + 1)
    for dims in ((3, 3, 3), (17, 17, 17), (18, 18, 18)):
        mesh = tt.grid_mesh(*dims, cell=0.05)
        try:
            fused.check_fits(mesh.num_particles)
            want = fused
        except ValueError:
            want = large
        assert (want is large) == (mesh.num_particles > limit)
        body = tt.World(device="cpu").add_body(mesh, engine=engine)
        assert body.kernel is want, (dims, engine)


def test_large_bodies_step_and_default_to_cuda():
    """A 9,261-particle box steps through World on the CPU (the twins), and
    without device= the large bodies ask for the card."""
    mesh = tt.grid_mesh(20, 20, 20, cell=0.05, origin=(-0.5, 0.3, -0.5))
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    nh = world.add_body(mesh, engine="neohookean")
    pol = world.add_body(mesh, engine="polar")
    assert nh.kernel is gs_levels and pol.kernel is polar_jacobi
    world.step(1)
    for b in (nh, pol):
        assert np.isfinite(b.positions).all()
        assert b.positions[:, 1].min() < mesh.verts[:, 1].min()
    assert nh.last_diag.shape == (2,)
    if not torch.cuda.is_available():
        for engine in ("neohookean", "polar"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tt.world.Body(mesh, engine=engine)


def test_jax_world_with_large_body_loads(tmp_path):
    """A JAX world file holding a Neo-Hookean and a polar body of 6,859
    particles loads in the port, which picks the multi-block modules, with
    the JAX states, and steps."""
    mesh = ts.grid_mesh(18, 18, 18, cell=0.05, origin=(-0.45, 0.3, -0.45))
    jw = ts.World(ts.PhysicsParams(num_substeps=1))
    jw.add_body(mesh, engine="neohookean")
    jw.add_body(mesh, engine="polar")
    rng = np.random.RandomState(3)
    for b in jw.bodies:
        b.state = b.state.replace(pos=np.asarray(
            mesh.verts + rng.normal(0, 0.002, mesh.verts.shape), np.float32))
    path = str(tmp_path / "large.npz")
    jw.save(path)
    tw = tt.World.load(path, device="cpu")
    assert [b.kernel for b in tw.bodies] == [gs_levels, polar_jacobi]
    for jb, tb in zip(jw.bodies, tw.bodies):
        np.testing.assert_array_equal(tb.positions, np.asarray(jb.state.pos))
    tw.step(1)
    assert all(np.isfinite(b.positions).all() for b in tw.bodies)
