"""tetsim_torch's World/Body vs tetsim_tpu.World on the dragon (the README
quick start), and the scene API's refusals."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_torch.kernels.gs_fused import FusedGSBody
from tetsim_torch.kernels.polar_fused import FusedPolarBody
from tetsim_torch.world import BatchedBody, Body

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dragon_pair():
    """Both packages: add_body(dragon), 1 frame; the port takes over the JAX
    state; grab near particle 100, move it, 1 more frame
    (default_cpu_params: 5 substeps, ordered GS).

    Each frame starts from the same state: after two frames the JAX package
    differs from itself by 1.8e-5 between its scan-frame and substep-jit
    compilations of the same math, so a frame is the horizon a 2e-5 bound
    can hold."""
    jw, tw = ts.World(ts.default_cpu_params()), tt.World(tt.default_cpu_params(), device="cpu")
    jb, tb = jw.add_body(ts.load_dragon()), tw.add_body(tt.load_dragon())
    jw.step(1)
    tw.step(1)
    first = np.abs(tb.positions - jb.positions).max()
    tb.state = convert.state_from_numpy(*(np.asarray(x) for x in (
        jb.state.pos, jb.state.prev_pos, jb.state.vel, jb.state.quats)), "cpu")
    point = jb.positions[100] + np.float32([0.0, 1e-3, 0.0])
    gids = jb.start_grab(point), tb.start_grab(point)
    target = point + np.float32([0.0, 0.2, 0.1])
    jb.move_grabbed(target)
    tb.move_grabbed(target)
    jw.step(1)
    tw.step(1)
    return jw, tw, jb, tb, gids, target, first


def test_dragon_world_matches_jax(dragon_pair):
    """Pre-contact dragon (min y 0.45): each frame within 2e-5 of the JAX
    ordered engine, which tests/test_neohookean.py holds to GoldenSolver."""
    jw, tw, jb, tb, gids, target, first = dragon_pair
    assert first < 2e-5
    assert gids == (100, 100)
    np.testing.assert_allclose(tb.positions, jb.positions, atol=2e-5)
    np.testing.assert_array_equal(tb.positions[100], target.astype(np.float32))
    np.testing.assert_allclose(tb.last_diag.numpy(), np.asarray(jb.last_diag),
                               atol=1e-5)
    jd, td = jw.diagnostics()["body0"], tw.diagnostics()["body0"]
    assert set(td) == set(jd)
    assert not td["nan"]
    for k in ("volume_error", "min_height", "solver_vol_error"):
        assert td[k] == pytest.approx(jd[k], abs=2e-5), k
    for k in ("kinetic_energy", "max_speed"):
        assert td[k] == pytest.approx(jd[k], rel=1e-3), k


def test_surface_mesh_matches_jax(dragon_pair):
    """Skinning and smooth normals on the same positions within 1e-5."""
    _, _, jb, tb, _, _, _ = dragon_pair
    tb.state = tb.state.replace(pos=torch.as_tensor(np.array(jb.positions)))
    jv, jn, jt = jb.surface_mesh()
    tv, tn, tris = tb.surface_mesh()
    assert tv.shape == (29800, 3) and tris.shape == (59657, 3)
    np.testing.assert_array_equal(tris, jt)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(tn, jn, atol=1e-5)
    np.testing.assert_allclose(tb.surface_positions(), jb.surface_positions(),
                               atol=1e-5)


def test_batch_world_and_release():
    """add_body_batch runs FusedGSBody; a released particle moves again."""
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    mesh = tt.grid_mesh(1, 1, 1, cell=0.5, origin=(-0.25, 0.1, -0.25))
    batch = world.add_body_batch(mesh, 3, engine="neohookean", backend="fused",
                                 jitter=0.1)
    body = world.add_body(mesh)
    assert isinstance(batch, FusedGSBody) and batch.num_bodies == 3
    batch.set_grab(2, 7, [0.0, 1.5, 0.0])
    body.start_grab(mesh.verts[7])
    body.move_grabbed([0.0, 1.5, 0.0])
    world.step(4)
    np.testing.assert_array_equal(batch.positions()[2, 7], np.float32([0, 1.5, 0]))
    np.testing.assert_array_equal(body.positions[7], np.float32([0, 1.5, 0]))
    d = world.diagnostics()
    assert d["body0"]["batch"] == 3 and not d["body0"]["nan"]
    assert d["body0"]["min_height"] >= -1e-5
    assert "volume_error" in d["body1"] and len(body.last_diag) == 2
    body.end_grab()
    world.step(3)
    assert int(body.controls.grab_id) == -1
    assert np.abs(body.positions[7] - np.float32([0, 1.5, 0])).max() > 1e-2


def test_unported_paths_raise():
    world = tt.World(tt.default_cpu_params(), device="cpu")
    mesh = tt.grid_mesh(1, 1, 1)
    with pytest.raises(ValueError, match="unknown engine"):
        world.add_body(mesh, engine="dense")
    with pytest.raises(ValueError, match="implements the neohookean engine"):
        world.add_body_batch(mesh, 2, backend="dense", engine="polar")
    with pytest.raises(ValueError, match="polar and neohookean"):
        world.add_body_batch(mesh, 2, engine="neohookean_grid")
    body = world.add_body(mesh)
    with pytest.raises(ValueError, match="render surface"):
        body.surface_mesh()
    dragon = world.add_body(tt.load_dragon())
    with pytest.raises(ValueError, match="polar engine"):
        dragon.surface_mesh(normals="rotated")


def test_cuda_world_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal applies where it has none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.World(tt.default_cpu_params(), device="cuda")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.World(device="meta")


def test_entry_points_default_to_cuda():
    """With no device= the entry points ask for the card: on a host without
    CUDA they raise rather than run on the CPU."""
    mesh = tt.grid_mesh(1, 1, 1)
    makers = (lambda: tt.World(), lambda: Body(mesh),
              lambda: FusedGSBody(mesh, 2), lambda: FusedPolarBody(mesh, 2),
              lambda: BatchedBody(mesh, 2))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
