"""tetsim_torch's dense Neo-Hookean engine (``solvers/dense.py`` with its
twin's level solve ``dense_level_reference``, ``DenseBody``) on the CPU
against tetsim_tpu.solvers.dense: the tables, the twin's level solve, frames, the
World path, the scene checkpoint and the viewer; and the refusals (the
size gate, TF32 for the twin on the card, no CUDA)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tests.test_torch_checkpoint import _assert_files_alike
from tests.test_torch_viewer import _get, _post, _split, _wait_frames
from tetsim_tpu import mesh as jax_mesh
from tetsim_tpu.solvers import dense as jdense
from tetsim_tpu.viewer import ViewerServer as JaxViewerServer
from tetsim_torch import mesh as torch_mesh
from tetsim_torch.kernels import dense_frame
from tetsim_torch.solvers import dense
from tetsim_torch.viewer import ViewerServer
from tetsim_torch.world import DenseBody

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.25, 0.1, -0.25))  # tests/test_dense.py's
WORLD = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh

# The JAX dense engine runs with jit disabled here (jax.disable_jit(), op by
# op, the same arithmetic): on XLA's CPU backend its compiled scan takes
# about 0.2 s per level at these sizes, 6 s per frame, against about 30 ms
# op by op.


def _meshes(dims=(2, 2, 2), box=SMALL):
    return ts.grid_mesh(*dims, **box), tt.grid_mesh(*dims, **box)


@pytest.mark.parametrize("coloring", ["greedy", "ordered"])
def test_tables_equal_jax(coloring):
    """The one-hot and the level tables equal the reference's bit for bit,
    shapes and C included."""
    jm, tm = _meshes()
    ja = jdense.build_dense_arrays(jm, coloring=coloring)
    ta = dense.build_dense_arrays(tm, coloring=coloring, device="cpu")
    assert (ta.num_particles, ta.slots_per_level) == (
        ja.num_particles, ja.slots_per_level)
    for k in ("onehot", "irp", "irv", "imc"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)), k)


def test_size_gate(dragon):
    """The dragon's slab past max_bytes is refused as in the reference."""
    with pytest.raises(ValueError, match="one-hot slab would need"):
        jdense.build_dense_arrays(dragon, max_bytes=1000)
    with pytest.raises(ValueError, match="one-hot slab would need"):
        dense.build_dense_arrays(tt.load_dragon(), max_bytes=1000,
                                 device="cpu")


def _jax_level(g, irp, irv, imc, params):
    """The reference's level solve on g [4C, 3B], as project_constraints
    calls it."""
    C, B = irv.shape[0], g.shape[1] // 3
    g4 = jnp.asarray(g).reshape(4, C, 3, B)
    p = [[g4[c, :, r, :] for r in range(3)] for c in range(4)]
    d = jdense._solve_level_planes(
        p, [jnp.asarray(irp[k])[:, None] for k in range(9)],
        jnp.asarray(irv)[:, None], [jnp.asarray(imc[c])[:, None] for c in range(4)],
        params.dt, params.dev_compliance, params.vol_compliance,
        params.vol_compliance / params.dev_compliance)
    return np.asarray(jnp.stack([jnp.stack([d[c][r] for r in range(3)], axis=1)
                                 for c in range(4)]).reshape(4 * C, 3 * B))


@pytest.mark.parametrize("vol_compliance", [0.0, 1e-6])
def test_level_twin_matches_jax(vol_compliance):
    """The twin's level solve on random corners (each level of the
    dragon's greedy schedule, B = 5): within 1e-6 of
    ``_solve_level_planes`` (both round each operation in f32; XLA may
    order a few differently), padded slots exactly 0."""
    mesh = tt.load_dragon()
    ids, irp, irv, imc = dense.level_tables(mesh, coloring="greedy")
    rng = np.random.RandomState(7)
    B, C = 5, irv.shape[1]
    jp = ts.PhysicsParams(vol_compliance=vol_compliance)
    tp = tt.PhysicsParams(vol_compliance=vol_compliance)
    worst = 0.0
    for l in range(0, irv.shape[0], 4):
        pos = (mesh.verts[:, :, None] + rng.normal(
            0, 0.01, (mesh.num_particles, 3, B))).astype(np.float32)
        g = pos[ids[l]].reshape(4 * C, 3 * B)
        want = _jax_level(g, irp[l], irv[l], imc[l], jp)
        got = dense.dense_level_reference(*(torch.as_tensor(x) for x in (
            g, irp[l], irv[l], imc[l])), tp).numpy()
        assert got.shape == (4 * C, 3 * B)
        worst = max(worst, float(np.abs(got - want).max()))
        pad = np.tile(irv[l] == 0.0, 4)
        assert not (got[pad] != 0.0).any()
    assert worst <= 1e-6


def _start(mesh, nb, seed):
    """A shared jittered start [N, 3, B] with seeded velocities."""
    rng = np.random.RandomState(seed)
    pos = (mesh.verts[:, :, None] + rng.uniform(-0.05, 0.05, (1, 3, nb))
           + [[[0.0], [0.3], [0.0]]]).astype(np.float32)
    vel = rng.normal(0, 0.3, pos.shape).astype(np.float32)
    return pos, vel


@pytest.fixture(scope="module")
def frames_run():
    """B = 3 from a shared start, body 1 grabbed, 4 frames of 2 substeps in
    each package: {frame: (port state, JAX state)} after frames 1 and 4."""
    jm, tm = _meshes()
    params_j, params_t = ts.PhysicsParams(num_substeps=2), tt.PhysicsParams(
        num_substeps=2)
    pos, vel = _start(tm, 3, seed=3)
    gid = np.int32([-1, 5, -1])
    gpos = np.zeros((3, 3), np.float32)
    gpos[:, 1] = [0.2, 1.4, 0.0]
    js = jdense.DenseState(pos=jnp.asarray(pos), prev_pos=jnp.asarray(pos),
                           vel=jnp.asarray(vel))
    ts_ = dense.DenseState(pos=torch.as_tensor(pos), prev_pos=torch.as_tensor(pos),
                           vel=torch.as_tensor(vel))
    ja = jdense.build_dense_arrays(jm)
    ta = dense.build_dense_arrays(tm, device="cpu")
    out = {}
    for f in range(1, 5):
        with jax.disable_jit():
            js = jdense.step_frame(js, ja, params_j, jnp.asarray(gid),
                                   jnp.asarray(gpos))
        ts_ = dense.step_frame(ts_, ta, params_t, torch.as_tensor(gid),
                               torch.as_tensor(gpos))
        out[f] = ts_, js
    return out, gpos


@pytest.mark.parametrize("frames,ptol,vtol", [(1, 2e-5, 2e-3), (4, 3e-4, 3e-2)])
def test_frames_match_jax(frames_run, frames, ptol, vtol):
    """After 1 frame within 2e-5 in positions and 2e-3 in velocities of the
    reference; after 4 within tests/test_dense.py's bars (3e-4, 3e-2); the
    grabbed particle on its target, the state contiguous [N, 3, B]."""
    out, gpos = frames_run
    ts_, js = out[frames]
    assert ts_.pos.is_contiguous() and ts_.pos.shape == js.pos.shape
    np.testing.assert_allclose(ts_.pos.numpy(), np.asarray(js.pos), atol=ptol)
    np.testing.assert_allclose(ts_.vel.numpy(), np.asarray(js.vel), atol=vtol)
    np.testing.assert_array_equal(ts_.pos.numpy()[5, :, 1], gpos[:, 1])


# Small members of the two shape families the global form serves on the
# card (a body over one block's shared memory): many copies of one tet, one
# level wide (L = 1), and many copies of a cube's six tets (L = 6).
FAMILIES = {"tet": lambda m: m.replicate_mesh(m.single_tet_mesh(), 64,
                                              jitter=0.5, seed=1),
            "cube": lambda m: m.replicate_mesh(
                m.grid_mesh(1, 1, 1, cell=0.1), 64, jitter=0.5, seed=2)}


@pytest.mark.parametrize("family,levels", [("tet", 1), ("cube", 6)])
def test_wide_families_match_jax(family, levels):
    """replicate_mesh(single_tet_mesh(), 64) and replicate_mesh(grid_mesh(1,
    1, 1, cell=0.1), 64), jittered copies: the same tables in both
    packages; B = 3 from a shared jittered start with seeded velocities,
    body 1 grabbed, 3 frames of 2 substeps: the twin within 2e-5 / 2e-3 of
    the reference after frame 1, and after frame 3 within
    tests/test_dense.py's 3e-4 / 3e-2 or twice the twin's own spread from
    starts 1 ulp apart (PERF.md's bars: the seeded velocities deform the
    0.1 m cubes hard enough that a 1-ulp change moves them by 1e-2 in 3
    frames); the grabbed particle on its target."""
    jm, tm = FAMILIES[family](jax_mesh), FAMILIES[family](torch_mesh)
    np.testing.assert_array_equal(tm.verts, jm.verts)
    ja = jdense.build_dense_arrays(jm)
    ta = dense.build_dense_arrays(tm, device="cpu")
    assert ta.num_levels == levels and ta.slots_per_level == ja.slots_per_level
    params_j, params_t = (ts.PhysicsParams(num_substeps=2),
                          tt.PhysicsParams(num_substeps=2))
    pos, vel = _start(tm, 3, seed=5)
    gid = np.int32([-1, 5, -1])
    gpos = np.zeros((3, 3), np.float32)
    gpos[:, 1] = pos[5, :, 1] + [0.0, 0.1, 0.0]
    js = jdense.DenseState(*(jnp.asarray(x) for x in (pos, pos, vel)))
    # the twin from the start and from starts 1 ulp above and below it
    twins = [dense.DenseState(*(torch.as_tensor(x) for x in (p, p, vel)))
             for p in (pos, np.nextafter(pos, np.float32(10)),
                       np.nextafter(pos, np.float32(-10)))]

    def spread(k):
        return max(float((getattr(twins[0], k) - getattr(s, k)).abs().max())
                   for s in twins[1:])

    for f in (1, 2, 3):
        with jax.disable_jit():
            js = jdense.step_frame(js, ja, params_j, jnp.asarray(gid),
                                   jnp.asarray(gpos))
        twins = [dense.step_frame(s, ta, params_t, torch.as_tensor(gid),
                                  torch.as_tensor(gpos)) for s in twins]
        if f == 2:
            continue
        ptol, vtol = ((2e-5, 2e-3) if f == 1 else
                      (max(3e-4, 2 * spread("pos")),
                       max(3e-2, 2 * spread("vel"))))
        np.testing.assert_allclose(twins[0].pos.numpy(), np.asarray(js.pos),
                                   atol=ptol)
        np.testing.assert_allclose(twins[0].vel.numpy(), np.asarray(js.vel),
                                   atol=vtol)
    np.testing.assert_array_equal(twins[0].pos.numpy()[5, :, 1], gpos[:, 1])


def test_nan_spreads_as_in_jax():
    """A NaN in one particle of body 0 reaches every particle of body 0
    through the products, and no other body, as in the reference."""
    jm, tm = _meshes()
    pos, vel = _start(tm, 3, seed=4)
    pos[3, 1, 0] = np.nan
    params = tt.PhysicsParams(num_substeps=1)
    s = dense.step_frame(
        dense.DenseState(*(torch.as_tensor(x) for x in (pos, pos, vel))),
        dense.build_dense_arrays(tm, device="cpu"), params,
        torch.full((3,), -1, dtype=torch.int32), torch.zeros(3, 3))
    with jax.disable_jit():
        js = jdense.step_frame(
            jdense.DenseState(*(jnp.asarray(x) for x in (pos, pos, vel))),
            jdense.build_dense_arrays(jm), ts.PhysicsParams(num_substeps=1),
            jnp.full((3,), -1, jnp.int32), jnp.zeros((3, 3)))
    np.testing.assert_array_equal(np.isnan(s.pos.numpy()),
                                  np.isnan(np.asarray(js.pos)))
    assert np.isnan(s.pos.numpy()[:, :, 0]).all()
    assert np.isfinite(s.pos.numpy()[:, :, 1:]).all()


def test_world_dense_batch_matches_jax():
    """tests/test_world.py's dense World path in both packages: 2 frames,
    [3, N, 3] positions, diagnostics of the batch, a grab on body 1 moved
    and held for a frame, released; each package's positions within
    tests/test_dense.py's 3e-4 of the other's, the grab on target."""
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    tw = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    jmesh, tmesh = _meshes()
    jb = jw.add_body_batch(jmesh, 3, engine="neohookean",
                           backend="dense", jitter=0.05)
    tb = tw.add_body_batch(tmesh, 3, engine="neohookean", backend="dense",
                           jitter=0.05)
    assert isinstance(tb, DenseBody) and tb.engine == "dense"
    assert tb.last_diag is None
    np.testing.assert_array_equal(tb.positions(), jb.positions())
    with jax.disable_jit():
        jw.step(2)
    tw.step(2)
    pos = tb.positions()
    assert pos.shape == (3, tmesh.num_particles, 3) and np.isfinite(pos).all()
    np.testing.assert_allclose(pos, jb.positions(), atol=3e-4)
    np.testing.assert_allclose(tb.velocities(), jb.velocities(), atol=3e-2)
    d = tw.diagnostics()["body0"]
    assert set(d) == {"batch", "min_height", "max_speed", "nan"}
    assert d["batch"] == 3 and not d["nan"]
    assert d["min_height"] == pytest.approx(float(pos[..., 1].min()))
    point = pos[1].mean(axis=0)
    pid = tb.start_grab(1, point)
    assert pid == jb.start_grab(1, point)
    target = point + np.float32([0, 0.2, 0])
    tb.move_grabbed(1, target)
    jb.move_grabbed(1, target)
    with jax.disable_jit():
        jw.step(1)
    tw.step(1)
    np.testing.assert_array_equal(tb.positions()[1, pid], target)
    np.testing.assert_allclose(tb.positions(), jb.positions(), atol=3e-4)
    tb.end_grab(1)
    assert int(tb.grab_id[1]) == -1
    with pytest.raises(IndexError, match="out of range"):
        tb.set_grab(3, 0, point)


def test_scene_file_jax_port_jax(tmp_path):
    """A dense batch's scene file goes JAX -> port -> JAX with equal states,
    keys, shapes and dtypes ([N, 3, B], grab_id [B], grab_pos [3, B]); the
    port's own file has the JAX file's keys and shapes, and its restored
    state is contiguous and steps bit for bit like the state it saved."""
    jmesh, tmesh = _meshes()
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    jb = jw.add_body_batch(jmesh, 3, engine="neohookean",
                           backend="dense", jitter=0.05)
    jb.set_grab(2, 9, [0.1, 1.2, 0.0])
    with jax.disable_jit():
        jw.step(1)
    j1, p1, j2 = (str(tmp_path / f) for f in ("j1.npz", "p1.npz", "j2.npz"))
    jw.save(j1)
    tw = tt.World.load(j1, device="cpu")
    tb = tw.bodies[0]
    assert type(tb) is DenseBody and tb.num_bodies == 3
    assert all(getattr(tb, k).is_contiguous()
               for k in ("pos", "prev_pos", "vel", "grab_id", "grab_pos"))
    tw.save(p1)
    _assert_files_alike(j1, p1)
    with np.load(p1) as z:
        n = tmesh.num_particles
        assert z["b0.pos"].shape == (n, 3, 3) and z["b0.grab_pos"].shape == (3, 3)
        assert z["b0.grab_id"].dtype == np.int32 and z["b0.grab_id"].shape == (3,)
    ts.World.load(p1).save(j2)
    _assert_files_alike(j1, j2)

    fresh = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    fresh.add_body_batch(tmesh, 3, engine="neohookean", backend="dense",
                         jitter=0.05)
    p0 = str(tmp_path / "p0.npz")
    fresh.save(p0)
    _assert_files_alike(j1, p0, values=False)
    again = tt.World.load(p1, device="cpu")
    tw.step(2)
    again.step(2)
    for k in ("pos", "prev_pos", "vel"):
        assert torch.equal(getattr(tw.bodies[0], k), getattr(again.bodies[0], k))


def test_viewer_serves_dense_batch():
    """A DenseBody renders as a packed view: /mesh byte for byte the JAX
    server's, the rest /state within 1e-5 of it; live, a grab ray goes to
    the owning body's slot and holds its target, /reset drops every grab;
    a reset restores the start."""
    mesh_j = ts.with_boundary_surface(ts.grid_mesh(3, 3, 3, **WORLD))
    mesh_t = tt.with_boundary_surface(tt.grid_mesh(3, 3, 3, **WORLD))
    jw = ts.World(ts.PhysicsParams(num_substeps=1))
    jw.add_body_batch(mesh_j, 4, engine="neohookean", backend="dense",
                      jitter=0.05)
    world = tt.World(tt.PhysicsParams(num_substeps=1), device="cpu")
    body = world.add_body_batch(mesh_t, 4, engine="neohookean",
                                backend="dense", jitter=0.05)
    jsrv = JaxViewerServer(jw)  # not started: methods driven directly
    rest = ViewerServer(world)
    jh, jp = _split(jsrv.state_blob())
    th, tp = _split(rest.state_blob())
    assert th == jh
    np.testing.assert_allclose(np.frombuffer(tp, "<f4"),
                               np.frombuffer(jp, "<f4"), atol=1e-5)
    start = body.pos.clone()
    srv = ViewerServer(world, port=0, fps=20.0).start()
    try:
        assert _get(srv.port, "/mesh") == jsrv.mesh_blob()
        c = body.positions().reshape(-1, 3).mean(axis=0)
        origin = c + np.float32([0.0, 0.3, 1.5])
        d = (c - origin) / np.linalg.norm(c - origin)
        out = _post(srv.port, "/grab", {"action": "start",
                                        "origin": origin.tolist(),
                                        "dir": d.tolist()})
        assert out["grabbed"] >= 0
        owner, local = divmod(out["grabbed"], mesh_t.num_particles)
        assert int(body.grab_id[owner]) == local
        _post(srv.port, "/grab", {"action": "move", "dir": d.tolist(),
                                  "origin": (origin + [0, 0.4, 0]).tolist()})
        _wait_frames(srv)
        with srv._lock:
            assert torch.equal(body.pos[local, :, owner], body.grab_pos[:, owner])
        _post(srv.port, "/grab", {"action": "end"})
        assert int(body.grab_id[owner]) == -1
        body.set_grab(2, 3, [0.0, 1.0, 0.0])
        _post(srv.port, "/reset", {})
        assert (body.grab_id == -1).all()
    finally:
        srv.stop()
    srv.reset()  # the sim thread has stopped: nothing steps after the reset
    assert torch.equal(body.pos, start) and torch.equal(body.vel, 0 * start)


def test_cuda_step_refuses_tf32(monkeypatch):
    """The twin's one-hot products are exact only in full FP32: with TF32
    on, by either switch, the precision check the twin runs on CUDA raises
    and names the fix; at torch's default it passes."""
    dense.check_precision()
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="set_float32_matmul_precision"):
        dense.check_precision()
    monkeypatch.undo()
    dense.check_precision()
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32 is on"):
            dense.check_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    dense.check_precision()


def test_entry_point_defaults_to_cuda_and_kernel_refuses_cpu():
    """DenseBody with no device asks for the card (on a host without CUDA
    it raises rather than run on the CPU); the frame kernel's CUDA entry
    refuses CPU tensors."""
    mesh = tt.grid_mesh(1, 1, 1)
    if torch.cuda.is_available():
        assert DenseBody(mesh, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DenseBody(mesh, 2)
    arr = dense.build_dense_arrays(mesh, device="cpu")
    n = mesh.num_particles
    with pytest.raises(ValueError, match="runs on CUDA"):
        dense_frame.dense_frame(torch.zeros(n, 3, 2), torch.zeros(n, 3, 2),
                                arr, tt.PhysicsParams(),
                                torch.full((2,), -1, dtype=torch.int32),
                                torch.zeros(3, 2))
