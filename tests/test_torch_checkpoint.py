"""tetsim_torch's checkpoints (``checkpoint.py``, ``World.save`` /
``restore`` / ``load``) on the CPU: resume bit-exactly, refuse what does not
match, and read and write the JAX package's files, so a scene saved by
either package resumes in the other."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu import checkpoint as jck
from tetsim_torch import checkpoint

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh


def _small():
    return tt.grid_mesh(3, 3, 3, **SMALL)


def _world(params=None):
    return tt.World(params or tt.PhysicsParams(num_substeps=2), device="cpu")


def test_resume_exact(tmp_path):
    """5 frames, save, 5 more; load and replay the 5: bitwise equal."""
    world = _world(tt.PhysicsParams(num_substeps=5))
    body = world.add_body(_small(), engine="neohookean")
    world.step(5)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, body.state)
    world.step(5)
    ref = body.positions.copy()
    body.state = checkpoint.load(path, device="cpu")
    world.step(5)
    np.testing.assert_array_equal(body.positions, ref)


def test_validation(tmp_path):
    """Engine, mesh, structure and shape mismatches raise clearly
    (tests/test_world.py's cases)."""
    body = _world().add_body(_small(), engine="polar")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, body.state, mesh=_small(), engine="polar")
    out = checkpoint.load(path, like=body.state, mesh=_small(), engine="polar")
    assert torch.equal(out.pos, body.state.pos) and out.pos.device.type == "cpu"
    with pytest.raises(ValueError, match="engine"):
        checkpoint.load(path, mesh=_small(), engine="neohookean", device="cpu")
    other = tt.grid_mesh(4, 4, 4, cell=0.2)
    with pytest.raises(ValueError, match="does not match this mesh"):
        checkpoint.load(path, mesh=other, engine="polar", device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        checkpoint.load(path, like=tt.init_state(other, "cpu"))
    with pytest.raises(ValueError, match="structure|shapes"):
        checkpoint.load(path, like={"a": np.zeros(3)}, device="cpu")


def test_corruption_and_unstamped_mesh_guard(tmp_path):
    state = tt.init_state(_small(), "cpu")
    path = str(tmp_path / "plain.npz")
    checkpoint.save(path, state)  # unstamped
    with pytest.raises(ValueError, match="rows"):
        checkpoint.load(path, mesh=tt.grid_mesh(4, 4, 4), device="cpu")
    out = checkpoint.load(path, mesh=_small(), device="cpu")
    assert torch.equal(out.pos, state.pos)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["leaf0"] = data["leaf0"][:-1]
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **data)
    with pytest.raises(ValueError, match="corrupt|shapes"):
        checkpoint.load(bad, device="cpu")


def test_state_files_cross_packages(tmp_path):
    """A SimState file of either package loads in the other, checked
    against a ``like`` state and the mesh."""
    jmesh = ts.grid_mesh(3, 3, 3, **SMALL)
    rng = np.random.RandomState(0)
    jstate = ts.init_state(jmesh).replace(
        pos=np.asarray(jmesh.verts + rng.normal(0, 0.01, jmesh.verts.shape),
                       np.float32))
    jpath = str(tmp_path / "jax.npz")
    jck.save(jpath, jstate, mesh=jmesh, engine="neohookean")
    like = tt.init_state(_small(), "cpu")
    got = checkpoint.load(jpath, like=like, mesh=_small(), engine="neohookean")
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(jstate.pos))
    tpath = str(tmp_path / "port.npz")
    checkpoint.save(tpath, got, mesh=_small(), engine="neohookean")
    back = jck.load(tpath, like=jstate, mesh=jmesh, engine="neohookean")
    np.testing.assert_array_equal(np.asarray(back.pos), np.asarray(jstate.pos))


def _mixed(params):
    w = _world(params)
    w.add_body(_small(), engine="polar")
    w.add_grid_body_batch((3, 3, 3), 2, cell=0.2, engine="polar_grid")
    w.add_grid_body((2, 2, 3), cell=0.25, origin=(0.0, 0.5, 0.0),
                    engine="polar_grid_pallas", packed=True)
    return w


def test_world_scene_roundtrip(tmp_path):
    """A mixed world (Body, GridBodyBatch, PackedGridBody) with active
    grabs: restore into a matching world and a rebuild from the file alone
    both resume the same session, bit for bit."""
    params = tt.PhysicsParams(num_substeps=2)
    world = _mixed(params)
    world.step(3)
    world.bodies[0].start_grab([0.0, 1.0, 0.0])
    world.bodies[1].start_grab(1, [0.3, 0.8, 0.3])
    path = str(tmp_path / "scene.npz")
    world.save(path)
    world.step(3)
    ref = [np.asarray(b.positions) for b in world.bodies]
    grab = int(world.bodies[0].controls.grab_id)
    assert grab >= 0

    w2 = _mixed(params)
    w2.restore(path)
    assert int(w2.bodies[0].controls.grab_id) == grab
    assert int(w2.bodies[1].grab_id[1, 0]) >= 0
    w3 = tt.World.load(path, device="cpu")
    assert len(w3.bodies) == 3 and w3.params.num_substeps == 2
    for w in (w2, w3):
        w.step(3)
        for b, r in zip(w.bodies, ref):
            np.testing.assert_array_equal(np.asarray(b.positions), r)


def test_world_scene_validates(tmp_path):
    world = _world()
    world.add_body(_small(), engine="polar")
    path = str(tmp_path / "scene.npz")
    world.save(path)
    other = _world()
    other.add_body(_small(), engine="neohookean")
    with pytest.raises(ValueError, match="engine"):
        other.restore(path)
    with pytest.raises(ValueError, match="bodies"):
        _world().restore(path)
    prebuilt = _world()
    prebuilt.add_body(_small(), engine="polar",
                      arrays=tt.build_arrays(_small(), coloring=None,
                                             device="cpu"))
    prebuilt.save(path)
    with pytest.raises(ValueError, match="construction spec"):
        tt.World.load(path, device="cpu")


# -- the five body kinds across packages ----------------------------------------


def _add_five(world, mesh):
    world.add_body(mesh, engine="neohookean")
    world.add_body(mesh, engine="polar")
    world.add_body_batch(mesh, 8, engine="neohookean", backend="fused",
                         jitter=0.05, seed=3)
    world.add_body_batch(mesh, 3, engine="polar", backend="fused",
                         jitter=0.05, seed=4)
    world.add_body_batch(mesh, 8, engine="neohookean",
                         backend="fused_ordered", jitter=0.05, seed=5)


def _jax_views(b):
    """(pos, prev, vel, quats or None, grab ids, grab targets) of a JAX
    body as numpy, batches [B, N, 3]."""
    if hasattr(b, "controls"):
        s, c = b.state, b.controls
        return (np.asarray(s.pos), np.asarray(s.prev_pos), np.asarray(s.vel),
                np.asarray(s.quats), np.asarray(c.grab_id),
                np.asarray(c.grab_pos))
    nb, n = b.num_bodies, b.mesh.num_particles
    st = np.asarray(b.state)[:, :nb, :n]
    prev = np.moveaxis(st[3:6], 0, -1)
    quats = b.quaternions() if hasattr(b, "quaternions") else None
    return (b.positions(), prev, b.velocities(), quats,
            np.asarray(b.grab_id)[:nb, 0], np.asarray(b.grab_pos)[:nb, :3])


def _port_views(b):
    if hasattr(b, "controls"):
        s, c = b.state, b.controls
        return tuple(x.numpy() for x in (s.pos, s.prev_pos, s.vel, s.quats,
                                         c.grab_id, c.grab_pos))
    quats = b.quats.numpy() if hasattr(b, "quats") else None
    return (b.pos.numpy(), b.prev_pos.numpy(), b.vel.numpy(), quats,
            b.grab_id[:, 0].numpy(), b.grab_pos[:, 0].numpy())


def _assert_same(jw, tw):
    assert [type(b).__name__ for b in jw.bodies] == [
        type(b).__name__ for b in tw.bodies]
    assert jw.params.num_substeps == tw.params.num_substeps
    for jb, tb in zip(jw.bodies, tw.bodies):
        for j, t in zip(_jax_views(jb), _port_views(tb)):
            if j is None:
                assert t is None
                continue
            np.testing.assert_array_equal(t, j, type(tb).__name__)


def test_jax_world_file_loads_in_port(tmp_path):
    """A scene written by tetsim_tpu (the five body kinds on small_mesh,
    stepped or perturbed, with grabs) loads in the port with equal states."""
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    _add_five(jw, ts.grid_mesh(3, 3, 3, **SMALL))
    for b in jw.bodies[:2]:  # the Bodies (XLA); the batches are perturbed
        for _ in range(2):
            b.step(jw.params)
    rng = np.random.RandomState(7)
    for b in jw.bodies[2:]:
        b.state = b.state + rng.normal(0, 0.01, b.state.shape).astype(np.float32)
        b.set_grab(1, 9, [0.1, 1.2, 0.0])
    q = rng.normal(size=np.asarray(jw.bodies[3].quats).shape).astype(np.float32)
    jw.bodies[3].quats = q / np.linalg.norm(q, axis=0, keepdims=True)
    jw.bodies[0].start_grab([0.0, 1.0, 0.0])
    path = str(tmp_path / "jax_scene.npz")
    jw.save(path)
    tw = tt.World.load(path, device="cpu")
    _assert_same(jw, tw)
    for b in tw.bodies:  # the kernels take contiguous tensors only
        for x in (vars(b.state) if hasattr(b, "controls") else vars(b)
                  ).values():
            assert not torch.is_tensor(x) or x.is_contiguous()
    tw.step(1)  # and it runs
    assert all(not d["nan"] for d in tw.diagnostics().values())


def test_port_world_file_loads_in_jax(tmp_path):
    """The reverse: the port's scene, stepped with grabs, loads in tetsim_tpu
    with equal states (quaternions of the fused polar batch included)."""
    tw = _world()
    _add_five(tw, _small())
    tw.bodies[0].start_grab([0.0, 1.0, 0.0])
    for b in tw.bodies[2:]:
        b.set_grab(1, 9, [0.1, 1.2, 0.0])
    tw.step(2)
    path = str(tmp_path / "port_scene.npz")
    tw.save(path)
    jw = ts.World.load(path)
    _assert_same(jw, tw)
    assert np.abs(tw.bodies[3].quats.numpy()[..., 3] - 1.0).max() > 1e-6


# -- the other body kinds, and the files' key shapes ---------------------------


def _add_five_more(world, mesh):
    """The kinds the five above leave out: a grid Body, a packed grid body,
    the flat polar batch and both pieces bodies."""
    world.add_grid_body((3, 3, 3), cell=0.2, engine="polar_grid")
    world.add_grid_body((2, 2, 3), cell=0.25, origin=(0.0, 0.5, 0.0),
                        engine="polar_grid_pallas", packed=True)
    world.add_body_batch(mesh, 3, engine="polar", backend="flat",
                         jitter=0.05, seed=2)
    world.add_body(mesh, engine="polar_pieces")
    world.add_body(mesh, engine="nh_pieces")


def _perturbed(path, out, seed):
    """Copy a scene file with every body moved off rest (pos and prev by
    the same seeded noise, so a packed body's velocity stays 0), its
    quaternions turned and a grab set on particle 9 (body 1 of a batch)."""
    rng = np.random.RandomState(seed)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    for k in sorted(data):
        if k.endswith(".pos"):
            noise = rng.normal(0, 0.01, data[k].shape).astype(np.float32)
            data[k] = data[k] + noise
            data[k[:-3] + "prev_pos"] = data[k[:-3] + "prev_pos"] + noise
        elif k.endswith(".quats") and data[k].ndim == 2:
            q = data[k] + rng.normal(0, 0.1, data[k].shape).astype(np.float32)
            data[k] = q / np.linalg.norm(q, axis=-1, keepdims=True)
        elif k.endswith(".grab_id") and k[:-8] + ".pos" in data:
            gid = data[k]
            if gid.ndim == 0:
                data[k] = np.int32(9)
            else:  # a flat batch: body 1's slot holds a flat id
                n = data[k[:-8] + ".pos"].shape[0] // gid.shape[0]
                data[k] = np.int32([-1, n + 9] + [-1] * (gid.shape[0] - 2))
            data[k[:-8] + ".grab_pos"] = np.full(
                data[k[:-8] + ".grab_pos"].shape, 0.3, np.float32)
    np.savez_compressed(out, **data)


def _assert_files_alike(a_path, b_path, values=True):
    """Same body keys, each with the same shape and dtype (and values)."""
    with np.load(a_path) as a, np.load(b_path) as b:
        keys = sorted(k for k in a.files if k.startswith("b"))
        assert keys == sorted(k for k in b.files if k.startswith("b"))
        for k in keys:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            if values:
                np.testing.assert_array_equal(a[k], b[k], k)


def test_five_more_kinds_jax_port_jax(tmp_path):
    """Grid Body, packed grid body, flat polar batch and both pieces bodies
    (perturbed, with grabs) go JAX -> port -> JAX with equal states, keys
    and shapes, a restored grab_id keeping shape ()."""
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    _add_five_more(jw, ts.grid_mesh(3, 3, 3, **SMALL))
    j0, j1 = str(tmp_path / "j0.npz"), str(tmp_path / "j1.npz")
    jw.save(j0)
    _perturbed(j0, j1, seed=11)
    tw = tt.World.load(j1, device="cpu")
    assert [type(b).__name__ for b in tw.bodies] == [
        "Body", "PackedGridBody", "BatchedBody", "Body", "Body"]
    assert tw.bodies[0].controls.grab_id.shape == ()
    p1 = str(tmp_path / "p1.npz")
    tw.save(p1)
    _assert_files_alike(j1, p1)
    j2 = str(tmp_path / "j2.npz")
    ts.World.load(p1).save(j2)
    _assert_files_alike(j1, j2)


@pytest.mark.parametrize("kinds", ["five", "five_more"])
def test_port_files_have_jax_key_shapes(tmp_path, kinds):
    """The same scene built by each package: the port's file, fresh and
    after a restore, has the JAX file's keys, shapes and dtypes (grab_id
    of a single body shape (), not (1,))."""
    add = _add_five if kinds == "five" else _add_five_more
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    add(jw, ts.grid_mesh(3, 3, 3, **SMALL))
    tw = _world()
    add(tw, _small())
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jw.save(jpath)
    tw.save(tpath)
    _assert_files_alike(jpath, tpath, values=False)
    tw.restore(jpath)  # (the fused batches' padded bodies are not kept)
    again = str(tmp_path / "t2.npz")
    tw.save(again)
    _assert_files_alike(jpath, again, values=False)
