"""tetsim_torch's multi-device forms (``parallel/sharding.py``,
``parallel/nh_shard.py``, ``FusedGSBody.shard`` / ``FusedPolarBody.shard``)
on ``DeviceMesh``es of CPU devices, against tetsim_tpu's
``make_sharded_step`` / ``nh_shard`` on the 8 virtual devices that
``tests/conftest.py`` sets up, and against the port's own unsharded
engines, on numpy-seeded inputs and the 162-tet ``small_mesh``.

Bars: against JAX 2e-5 on positions and quaternions, the bar of
``tests/test_sharding.py``, and 2e-2 on velocities (they are
(pos - prev) / dt, with dt = 1/300); against the port's unsharded engine
1e-6 on positions and quaternions (the polar shards re-associate each
particle's sum; the Neo-Hookean shards apply the unsharded level updates);
a sharded fused batch bit for bit its unsharded self."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_torch.kernels.gs_fused import FusedGSBody
from tetsim_torch.kernels.polar_fused import FusedPolarBody
from tetsim_torch.parallel import (DeviceMesh, batch_controls, batch_state,
                                   make_sharded_step, nh_shard, pad_quats,
                                   pad_slots, pad_tet_arrays, prepare)
from tetsim_tpu import parallel as jparallel
from tetsim_tpu.parallel import nh_shard as jnh_shard

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))


def _mesh():
    return tt.grid_mesh(3, 3, 3, **SMALL)


def _seeded(jmesh, seed=3):
    """The JAX state of ``jmesh`` with seeded velocities."""
    s = ts.init_state(jmesh)
    rng = np.random.RandomState(seed)
    return s.replace(vel=jnp.asarray(
        rng.uniform(-0.5, 0.5, s.vel.shape).astype(np.float32)))


def _port_state(s):
    return convert.state_from_numpy(*(np.asarray(x) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)), "cpu")


def _grab(jmesh):
    gid = int(np.argmax(jmesh.verts[:, 1]))
    return gid, np.float32(jmesh.verts[gid] + [0.1, 0.3, 0.0])


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _jax_sharded(jmesh, engine, params, frames, d, controls, state=None,
                 coloring="ordered"):
    mesh = Mesh(np.array(jax.devices()[:d]), ("tet",))
    arr = ts.build_arrays(jmesh, coloring=coloring)
    s = ts.init_state(jmesh) if state is None else state
    s, arr = jparallel.prepare(s, arr, mesh, engine=engine, tet_axis="tet")
    step = jparallel.make_sharded_step(mesh, engine=engine, tet_axis="tet")
    for _ in range(frames):
        s, diags = step(s, arr, params, controls)
    return s, np.asarray(diags)


def _port_sharded(engine, params, frames, d, controls, state, arr):
    mesh = DeviceMesh(["cpu"] * d, "tet")
    s, tables = prepare(state, arr, mesh, engine=engine, tet_axis="tet")
    step = make_sharded_step(mesh, engine=engine, tet_axis="tet")
    for _ in range(frames):
        s, diags = step(s, tables, params, controls)
    return s, diags


# ---------------------------------------------------------------------------
# nh_shard tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("coloring", ["ordered", "greedy"])
def test_nh_shard_tables_equal_jax(small_mesh, shards, coloring):
    """The host-built tables array for array the JAX package's, statics,
    exchange rows, owners and bytes per substep included."""
    jarr = ts.build_arrays(small_mesh, coloring=coloring)
    want = jnh_shard.build_nh_shard_tables(
        jarr, np.asarray(small_mesh.verts), shards)
    got = nh_shard.build_nh_shard_tables(
        tt.build_arrays(_mesh(), coloring=coloring, device="cpu"),
        small_mesh.verts, shards)
    for f in ("num_particles", "num_tets", "L", "S", "Cs", "Eb"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("slot_tets", "slot_irp", "slot_irv", "slot_valid", "slot_imc",
              "linv", "xw", "owned", "xpid", "inv_mass"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (nh_shard.comm_bytes_per_substep(got)
            == jnh_shard.comm_bytes_per_substep(want)
            < got.L * got.num_particles * 12)


def test_nh_shard_refuses_bad_inputs():
    arr = tt.build_arrays(_mesh(), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        nh_shard.build_nh_shard_tables(arr, _mesh().verts, 3)
    polar = tt.build_arrays(_mesh(), coloring=None, device="cpu")
    with pytest.raises(ValueError, match="GS schedule"):
        nh_shard.build_nh_shard_tables(polar, _mesh().verts, 2)


# ---------------------------------------------------------------------------
# tet axis against JAX and against the port's unsharded engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 4])
def test_polar_tet_axis_matches_jax(small_mesh, d):
    """3 frames at 8 substeps from seeded velocities with a grab, d shards
    on both sides: positions, prev and quaternions 2e-5, velocities
    2e-2, diags 0."""
    params = ts.PhysicsParams(num_substeps=8)
    gid, target = _grab(small_mesh)
    s0 = _seeded(small_mesh)
    want, jdiags = _jax_sharded(
        small_mesh, "polar", params, 3, d,
        ts.Controls(grab_id=jnp.int32(gid), grab_pos=jnp.asarray(target)), s0)
    got, diags = _port_sharded(
        "polar", tt.PhysicsParams(num_substeps=8), 3, d,
        tt.Controls(torch.tensor(gid, dtype=torch.int32),
                    torch.as_tensor(target)),
        _port_state(s0), tt.build_arrays(_mesh(), device="cpu"))
    for f in ("pos", "prev_pos", "quats"):
        _close(getattr(got, f), getattr(want, f), 2e-5)
    _close(got.vel, want.vel, 2e-2)
    np.testing.assert_array_equal(diags.numpy(), jdiags)
    np.testing.assert_array_equal(got.pos[gid].numpy(), target)


@pytest.mark.parametrize("d", [2, 4])
def test_neohookean_tet_axis_matches_jax(small_mesh, d):
    """``nh_shard`` on d shards, 3 frames at 4 substeps with a grab (the
    JAX test's case): positions and prev 2e-5, velocities 2e-2, the mean
    volume error per substep 1e-5."""
    params = ts.PhysicsParams(num_substeps=4)
    gid, target = _grab(small_mesh)
    want, jdiags = _jax_sharded(
        small_mesh, "neohookean", params, 3, d,
        ts.Controls(grab_id=jnp.int32(gid), grab_pos=jnp.asarray(target)))
    got, diags = _port_sharded(
        "neohookean", tt.PhysicsParams(num_substeps=4), 3, d,
        tt.Controls(torch.tensor(gid, dtype=torch.int32),
                    torch.as_tensor(target)),
        tt.init_state(_mesh(), "cpu"), tt.build_arrays(_mesh(), device="cpu"))
    for f in ("pos", "prev_pos"):
        _close(getattr(got, f), getattr(want, f), 2e-5)
    _close(got.vel, want.vel, 2e-2)
    _close(diags, jdiags, 1e-5)
    np.testing.assert_array_equal(got.pos[gid].numpy(), target)


@pytest.mark.parametrize("engine", ["polar", "neohookean"])
@pytest.mark.parametrize("d", [2, 4])
def test_tet_axis_matches_unsharded(engine, d):
    """The port's tet axis against its own engine, 3 frames from seeded
    velocities with a grab: positions, prev, velocities times dt and
    quaternions 1e-6, diags 1e-6."""
    mesh = _mesh()
    params = tt.PhysicsParams(num_substeps=5)
    arr = tt.build_arrays(mesh, coloring=None if engine == "polar" else
                          "greedy", device="cpu")
    s0 = _port_state(_seeded(ts.grid_mesh(3, 3, 3, **SMALL)))
    gid, target = _grab(mesh)
    ctl = tt.Controls(torch.tensor(gid, dtype=torch.int32),
                      torch.as_tensor(target))
    got, diags = _port_sharded(engine, params, 3, d, ctl, s0, arr)
    ref = s0
    for _ in range(3):
        ref, rdiags = tt.get_engine(engine).step_frame(ref, arr, params, ctl)
    for f in ("pos", "prev_pos"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=1e-6)
    torch.testing.assert_close(got.vel * float(params.dt),
                               ref.vel * float(params.dt), rtol=0, atol=1e-6)
    torch.testing.assert_close(got.quats[:mesh.num_tets], ref.quats, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(diags, rdiags, rtol=0, atol=1e-6)


def test_nh_shard_exchange_is_compact_and_owned_once(small_mesh):
    """Every exchange row names a particle, each particle has one owner,
    and shards on two devices give the bits of shards on one (the move of
    each device's buffer against the one add)."""
    arr = tt.build_arrays(_mesh(), device="cpu")
    t = nh_shard.build_nh_shard_tables(arr, small_mesh.verts, 4)
    assert (t.owned.sum(dim=0) == 1).all()
    xpid = t.xpid.numpy()
    assert ((xpid >= 0) & (xpid <= t.num_particles)).all()
    params = tt.PhysicsParams(num_substeps=3)
    state = _port_state(_seeded(ts.grid_mesh(3, 3, 3, **SMALL)))
    outs = []
    for devices in (["cpu"] * 4, ["cpu", "cpu", "cpu:0", "cpu:0"]):
        placed = nh_shard.place(t, [torch.device(x) for x in devices])
        outs.append(nh_shard.step_frame(state, placed, params,
                                        tt.Controls.none("cpu")))
    assert len(nh_shard.place(t, ["cpu", "cpu", "cpu:0", "cpu:0"]).groups) == 2
    torch.testing.assert_close(outs[0][0].pos, outs[1][0].pos, rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# body axis
# ---------------------------------------------------------------------------


def test_body_and_tet_axes_match_jax(small_mesh):
    """A 4 x 2 (body, tet) mesh, 8 jitter-free bodies with a grab on body
    5, polar, 2 frames (``tests/test_sharding.py``'s 2-D case): within
    2e-5 of JAX's make_sharded_step on the same mesh shape."""
    params = ts.PhysicsParams(num_substeps=4)
    gid, target = _grab(small_mesh)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("body", "tet"))
    js = jparallel.batch_state(ts.init_state(small_mesh), 8)
    js, jarr = jparallel.prepare(js, ts.build_arrays(small_mesh), jmesh,
                                 engine="polar", tet_axis="tet",
                                 body_axis="body")
    jc = jparallel.batch_controls(8)
    jc = jc.replace(grab_id=jc.grab_id.at[5].set(gid),
                    grab_pos=jc.grab_pos.at[5].set(target))
    jc = jparallel.place(jc, jparallel.control_specs("body"), jmesh)
    jstep = jparallel.make_sharded_step(jmesh, engine="polar",
                                        tet_axis="tet", body_axis="body")

    mesh = DeviceMesh([["cpu"] * 2] * 4, ("body", "tet"))
    s = batch_state(tt.init_state(_mesh(), "cpu"), 8)
    s, tables = prepare(s, tt.build_arrays(_mesh(), device="cpu"), mesh,
                        engine="polar", tet_axis="tet", body_axis="body")
    ctl = batch_controls(8, "cpu")
    ctl.grab_id[5], ctl.grab_pos[5] = gid, torch.as_tensor(target)
    step = make_sharded_step(mesh, engine="polar", tet_axis="tet",
                             body_axis="body")
    for _ in range(2):
        js, jdiags = jstep(js, jarr, params, jc)
        s, diags = step(s, tables, tt.PhysicsParams(num_substeps=4), ctl)
    assert s.pos.shape == (8, small_mesh.num_particles, 3)
    assert diags.shape == (8, 4)
    for f in ("pos", "prev_pos", "quats"):
        _close(getattr(s, f), getattr(js, f), 2e-5)
    _close(s.vel, js.vel, 2e-2)
    np.testing.assert_array_equal(s.pos[5, gid].numpy(), target)
    torch.testing.assert_close(s.pos[0], s.pos[1], rtol=0, atol=0)


def test_body_axis_matches_jax_and_the_fused_batch(small_mesh):
    """Body axis alone, Neo-Hookean on the greedy schedule, 8 jittered
    bodies over 4 devices, 2 frames: 2e-5 of JAX's vmapped engine on the
    same mesh (``batch_state``'s offsets handed over), and bit for bit
    ``FusedGSBody`` with the same jitter, sharded over the same devices."""
    params = ts.PhysicsParams(num_substeps=5)
    s = batch_state(tt.init_state(_mesh(), "cpu"), 8, jitter=0.3, seed=2)
    jmesh = Mesh(np.array(jax.devices()[:4]), ("body",))
    js = ts.SimState(*(jnp.asarray(x.numpy()) for x in (
        s.pos, s.prev_pos, s.vel, s.quats)))
    js, jarr = jparallel.prepare(js, ts.build_arrays(small_mesh,
                                                     coloring="greedy"),
                                 jmesh, engine="neohookean", tet_axis=None,
                                 body_axis="body")
    jstep = jparallel.make_sharded_step(jmesh, engine="neohookean",
                                        tet_axis=None, body_axis="body")
    jc = jparallel.place(jparallel.batch_controls(8),
                         jparallel.control_specs("body"), jmesh)

    mesh = DeviceMesh(["cpu"] * 4, "body")
    s, tables = prepare(s, tt.build_arrays(_mesh(), coloring="greedy",
                                           device="cpu"),
                        mesh, engine="neohookean", tet_axis=None,
                        body_axis="body")
    step = make_sharded_step(mesh, engine="neohookean", tet_axis=None,
                             body_axis="body")
    batch = FusedGSBody(_mesh(), 8, jitter=0.3, seed=2, device="cpu")
    batch.shard(mesh, "body")
    tp = tt.PhysicsParams(num_substeps=5)
    for _ in range(2):
        js, jdiags = jstep(js, jarr, params, jc)
        s, diags = step(s, tables, tp, batch_controls(8, "cpu"))
        batch.step(tp)
    _close(s.pos, js.pos, 2e-5)
    _close(s.vel, js.vel, 2e-2)
    _close(diags, jdiags, 1e-5)
    torch.testing.assert_close(batch.pos, s.pos, rtol=0, atol=0)
    torch.testing.assert_close(batch.last_diag, diags, rtol=0, atol=0)


@pytest.mark.parametrize("cls", [FusedGSBody, FusedPolarBody])
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_fused_batch_is_the_unsharded_batch(cls, d, tmp_path):
    """A fused batch of 8 jittered bodies split over d CPU devices, a grab
    on body 5 and one ended on body 1: the plain twins' frames bit for bit
    the unsharded batch after each of 3 frames (positions, velocities,
    quaternions, vol_err), grab reads and writes land on the right part,
    and the scene checkpoint writes the same arrays."""
    mesh = _mesh()
    params = tt.PhysicsParams(num_substeps=3)
    worlds, batches = [], []
    for shard in (False, True):
        w = tt.World(params, device="cpu")
        b = w.add_body_batch(mesh, 8, engine="polar" if cls is FusedPolarBody
                             else "neohookean", backend="fused", jitter=0.3,
                             seed=4)
        if shard:
            assert b.shard(DeviceMesh(["cpu"] * d, "body")) is b
            assert [lo for _, lo, _ in b.parts] == list(range(0, 8, 8 // d))
        b.start_grab(1, [0.0, 2.0, 0.0])
        b.end_grab(1)
        pid = b.start_grab(5, mesh.verts[7] + 0.05)
        b.move_grabbed(5, mesh.verts[7] + [0.0, 0.2, 0.0])
        worlds.append(w)
        batches.append((b, pid))
    (ref, rpid), (sh, spid) = batches
    assert rpid == spid
    for _ in range(3):
        for w in worlds:
            w.step(1)
        np.testing.assert_array_equal(sh.positions(), ref.positions())
        np.testing.assert_array_equal(sh.velocities(), ref.velocities())
        if cls is FusedPolarBody:
            np.testing.assert_array_equal(sh.quaternions(), ref.quaternions())
        else:
            np.testing.assert_array_equal(sh.last_diag.numpy(),
                                          ref.last_diag.numpy())
    np.testing.assert_array_equal(sh.grab_id.numpy(), ref.grab_id.numpy())
    assert sh.summary() == ref.summary()
    paths = [str(tmp_path / f"{k}.npz") for k in ("ref", "sh")]
    for w, p in zip(worlds, paths):
        w.save(p)
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # restoring into the sharded batch splits the state over its parts
    worlds[1].restore(paths[0])
    assert len(sh._fields["pos"]) == d
    np.testing.assert_array_equal(sh.positions(), ref.positions())


def test_shard_refuses_an_uneven_split():
    body = FusedPolarBody(_mesh(), 8, device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        body.shard(DeviceMesh(["cpu"] * 3, "body"))
    step = make_sharded_step(DeviceMesh(["cpu"] * 3, "body"), "polar",
                             tet_axis=None, body_axis="body")
    s, tables = prepare(batch_state(tt.init_state(_mesh(), "cpu"), 8),
                        tt.build_arrays(_mesh(), coloring=None, device="cpu"),
                        DeviceMesh(["cpu"] * 3, "body"), "polar", None, "body")
    with pytest.raises(ValueError, match="split evenly"):
        step(s, tables, tt.PhysicsParams(), batch_controls(8, "cpu"))


# ---------------------------------------------------------------------------
# pads, batches, the mesh
# ---------------------------------------------------------------------------


def test_pads_and_batches_match_jax(small_mesh):
    """pad_tet_arrays / pad_slots / pad_quats to a multiple of 4 and of 5,
    batch_state without jitter and batch_controls: the JAX package's
    arrays; batch_state's jitter is a rigid offset per body, y >= 0, the
    offsets FusedBatch draws for the same seed."""
    jarr = ts.build_arrays(small_mesh)
    arr = tt.build_arrays(_mesh(), device="cpu")
    js, s = ts.init_state(small_mesh), tt.init_state(_mesh(), "cpu")
    for k in (4, 5):
        for jp, tp, fields in (
                (jparallel.pad_tet_arrays(jarr, k), pad_tet_arrays(arr, k),
                 ("tets", "inv_rest_pose", "inv_rest_volume", "rest_volume",
                  "rest_centered")),
                (jparallel.pad_slots(jarr, k), pad_slots(arr, k),
                 ("slot_tets", "slot_inv_rest_pose", "slot_inv_rest_volume",
                  "slot_valid", "slot_inv_mass"))):
            for f in fields:
                np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                              np.asarray(getattr(jp, f)), f)
        np.testing.assert_array_equal(pad_quats(s, k).quats.numpy(),
                                      np.asarray(jparallel.pad_quats(js, k).quats))
    jb, b = jparallel.batch_state(js, 3), batch_state(s, 3)
    for f in ("pos", "prev_pos", "vel", "quats"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    jc, c = jparallel.batch_controls(3), batch_controls(3, "cpu")
    np.testing.assert_array_equal(c.grab_id.numpy(), np.asarray(jc.grab_id))
    np.testing.assert_array_equal(c.grab_pos.numpy(), np.asarray(jc.grab_pos))
    off = (batch_state(s, 4, jitter=0.5, seed=1).pos - s.pos).numpy()
    np.testing.assert_allclose(off, np.broadcast_to(off[:, :1], off.shape),
                               rtol=0, atol=1e-6)
    assert (off[..., 1] >= 0).all()
    assert not np.allclose(off[0], off[1]) and np.abs(off).max() <= 0.5
    fused = FusedGSBody(_mesh(), 4, jitter=0.5, seed=1, device="cpu")
    np.testing.assert_array_equal(fused.pos.numpy() - s.pos.numpy(), off)


def test_device_mesh_axes():
    mesh = DeviceMesh([["cpu"] * 2] * 3, ("body", "tet"))
    assert mesh.shape == {"body": 3, "tet": 2}
    assert mesh.axis_devices("tet") == [torch.device("cpu")] * 2
    assert len(mesh.axis_devices(("tet", "body"))) == 6
    assert mesh.device(body=2, tet=1) == torch.device("cpu")
    with pytest.raises(ValueError, match="do not fit"):
        DeviceMesh(["cpu"] * 2, ("body", "tet"))
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("x")
    with pytest.raises(ValueError, match="sharded engines"):
        make_sharded_step(mesh, "polar_grid")
    with pytest.raises(ValueError, match="cpu or cuda"):
        DeviceMesh(["meta"], "body")


def test_new_entry_points_default_to_cuda():
    """The slice's entry points ask for the card: a DeviceMesh of "cuda"
    and the examples without --device raise where CUDA is unavailable
    (no silent CPU fallback)."""
    import importlib.util

    if torch.cuda.is_available():
        assert DeviceMesh(["cuda"], "body").devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceMesh(["cuda"] * 2, "body")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("torch_drop_dragon", "torch_cantilever", "torch_scale_grid"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(repo, "examples", f"{name}.py"))
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            example.main(["--frames", "1"])
