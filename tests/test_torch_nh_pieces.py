"""tetsim_torch's Neo-Hookean pieces engine vs tetsim_tpu: the host
schedule's tables equal the JAX package's exactly, and the plain twin of
the per-piece sweep, with the torch phases around it, follows an
independent XLA implementation of the same two-level schedule (per-piece
coloured GS, cross-piece mean), written here on the JAX package's
``solve_tet_batch`` and schedule tables after tests/test_nh_pieces.py.

The JAX pieces kernel K5 is never run here (in interpret mode it takes
minutes on the CPU).  All on the 960-tet ellipsoid blob of the JAX
tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels import nh_pieces as jnh
from tetsim_tpu.solvers.neohookean import solve_tet_batch
from tetsim_torch import convert
from tetsim_torch.kernels import nh_pieces as nhp

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BLOB = dict(n=8, radii=(0.4, 0.3, 0.35), center=(0.0, 0.8, 0.0))
CW = jnh._CW


@pytest.fixture(scope="module")
def blobs():
    return ts.ellipsoid_mesh(**BLOB), tt.ellipsoid_mesh(**BLOB)


@pytest.fixture(scope="module")
def sched(blobs):
    return jnh.build_nh_pieces_schedule(blobs[0], tets_per_piece=128)


@pytest.fixture(scope="module")
def arr(blobs):
    return nhp.build_nh_pieces_arrays(blobs[1], tets_per_piece=128,
                                      device="cpu")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        f"{what}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
    assert np.array_equal(a, b), f"{what} differs"


@pytest.mark.parametrize("boundary_prefix", [False, True])
@pytest.mark.parametrize("tpp", [128, 512])
def test_schedule_tables_equal(blobs, tpp, boundary_prefix):
    ref = jnh.build_nh_pieces_schedule(blobs[0], tets_per_piece=tpp,
                                       boundary_prefix=boundary_prefix)
    port = nhp.build_nh_pieces_schedule(blobs[1], tets_per_piece=tpp,
                                        boundary_prefix=boundary_prefix)
    for f in dataclasses.fields(port):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, np.ndarray):
            _same(a, b, f.name)
        else:
            assert a == b, f.name


def test_live_counts(sched, arr):
    """n_live counts the live slots of each sub-level, a prefix: the slots
    whose tet has a non-zero inverse mass, and 4 x n_live live entries of
    winv per sub-level, 4M in all."""
    n_live = arr.n_live.numpy()
    assert n_live.sum() == 960 and n_live.max() <= CW
    slots = np.arange(CW)
    live = sched.cons[:, :, 10:14].max(axis=2) > 0  # [L, B, CW]
    assert np.array_equal(live, slots < n_live[..., None])
    assert np.array_equal((sched.winv >= 0).sum(axis=2), 4 * n_live)


def _reference(state, sched, params, gid, gpos, frames):
    """The two-level schedule in the global state space, on the JAX
    package's solve_tet_batch: per-piece sub-levels, then each particle's
    predicted position plus the mean of its per-piece deltas."""
    n = sched.num_particles
    g2l = jnp.asarray(sched.g2l.reshape(-1))
    inv_mass = jnp.asarray(sched.inv_mass)
    counts = jnp.zeros(n + 1).at[g2l].add(jnp.where(g2l < n, 1.0, 0.0))[:n]
    dt = params.dt

    @jax.jit
    def level(loc, ids, cons, inv):
        p = jnp.take_along_axis(loc, ids[..., None], axis=1)
        p = p.reshape(sched.B, 4, CW, 3).transpose(0, 2, 1, 3)
        irp = cons[:, :9, :].transpose(0, 2, 1).reshape(sched.B, CW, 3, 3)
        imc = cons[:, 10:14, :].transpose(0, 2, 1)
        delta, _ = solve_tet_batch(p, irp, cons[:, 9, :], imc, dt, params)
        newc = (p + delta).transpose(0, 2, 1, 3).reshape(sched.B, 4 * CW, 3)
        upd = jnp.take_along_axis(newc, jnp.maximum(inv, 0)[..., None], axis=1)
        return jnp.where((inv >= 0)[..., None], upd, loc)

    pos, vel = state.pos, state.vel
    for _ in range(frames * params.num_substeps):
        vel = vel + jnp.asarray([0.0, 1.0, 0.0]) * params.gravity * dt
        vel = jnp.where((inv_mass > 0.0)[:, None], vel, 0.0)
        prev = pos
        pred = pos + vel * dt
        padded = jnp.concatenate([pred, jnp.zeros((1, 3))])
        loc = padded[g2l].reshape(sched.B, sched.rp, 3)
        for l in range(sched.l_max):
            loc = level(loc, jnp.asarray(sched.lids[l]),
                        jnp.asarray(sched.cons[l]), jnp.asarray(sched.winv[l]))
        d = loc.reshape(-1, 3) - padded[g2l]
        pos = pred + (jnp.zeros((n + 1, 3)).at[g2l].add(d)[:n]
                      / counts[:, None])
        pos = jnp.clip(pos, params.world_min, params.world_max)
        below = pos[:, 1] < 0.0
        pos = pos.at[:, 1].set(jnp.where(below, 0.0, pos[:, 1]))
        k = jnp.minimum(1.0, dt * params.friction)
        for ax in (0, 2):
            pos = pos.at[:, ax].add(
                jnp.where(below, (prev[:, ax] - pos[:, ax]) * k, 0.0))
        for g in range(len(gid)):
            pos = jnp.where((jnp.arange(n) == gid[g])[:, None], gpos[g], pos)
        vel = (pos - prev) / dt
    return np.asarray(pos), np.asarray(vel)


def _run(state, arr, params, controls, frames):
    for _ in range(frames):
        state, diags = nhp.step_frame(state, arr, params, controls)
    assert torch.isnan(diags).all() and diags.shape == (params.num_substeps,)
    return state


@pytest.mark.parametrize("grab", [False, True])
def test_twin_matches_independent_reference(blobs, sched, arr, grab):
    """2 frames at 5 substeps from rest, with and without a grab on the top
    particle: positions within 2e-5 of the reference."""
    gid = int(np.argmax(blobs[1].verts[:, 1]))
    target = blobs[1].verts[gid] + np.float32([0.05, 0.3, 0.0])
    gids = [gid] if grab else []
    ref_pos, ref_vel = _reference(ts.init_state(blobs[0]), sched,
                                  ts.PhysicsParams(num_substeps=5), gids,
                                  [target], 2)
    controls = (tt.Controls(grab_id=torch.tensor(gid, dtype=torch.int32),
                            grab_pos=torch.tensor(target))
                if grab else tt.Controls.none("cpu"))
    got = _run(tt.init_state(blobs[1], "cpu"), arr,
               tt.PhysicsParams(num_substeps=5), controls, 2)
    np.testing.assert_allclose(got.pos.numpy(), ref_pos, atol=2e-5)
    np.testing.assert_allclose(got.vel.numpy(), ref_vel, atol=2e-3)
    if grab:
        np.testing.assert_array_equal(got.pos[gid].numpy(), target)


def _volumes(pos, tets):
    e = pos[tets[:, 1:]] - pos[tets[:, :1]]
    return np.linalg.det(e.astype(np.float64)) / 6.0


@pytest.mark.parametrize("radius", [0.2, 0.08])
def test_twin_follows_reference_by_cell(radius):
    """A 1,536-tet ball at the cell of the 62,370-tet blob (0.05) and of
    bench.py's 987,090-tet blob (0.02), 1 frame at 5 substeps from rest.
    At 0.05 the twin holds the reference within 2e-5 and no tet inverts.
    At 0.02 the schedule collapses the ball in both: a 1-ulp difference
    grows to tenths within the frame, so positions cannot be held, but
    both lose more than half their volume alike (within 0.1) and invert
    the same share of tets (within 0.05)."""
    blob = dict(n=8, radii=(radius,) * 3, center=(0.0, 0.75, 0.0))
    jm, tm = ts.ellipsoid_mesh(**blob), tt.ellipsoid_mesh(**blob)
    assert tm.num_tets == 1536
    ref_pos, _ = _reference(ts.init_state(jm),
                            jnh.build_nh_pieces_schedule(jm, tets_per_piece=128),
                            ts.PhysicsParams(num_substeps=5), [], [], 1)
    arr = nhp.build_nh_pieces_arrays(tm, tets_per_piece=128, device="cpu")
    got = _run(tt.init_state(tm, "cpu"), arr, tt.PhysicsParams(num_substeps=5),
               tt.Controls.none("cpu"), 1).pos.numpy()
    rest = _volumes(tm.verts, tm.tets)
    vols = [_volumes(p, tm.tets) for p in (ref_pos, got)]
    vol_err = [v.sum() / rest.sum() - 1.0 for v in vols]
    inverted = [(v < 0).mean() for v in vols]
    if radius == 0.2:
        np.testing.assert_allclose(got, ref_pos, atol=2e-5)
        assert inverted == [0.0, 0.0]
    else:
        assert max(vol_err) < -0.5 and abs(vol_err[0] - vol_err[1]) < 0.1
        assert min(inverted) > 0.25
        assert abs(inverted[0] - inverted[1]) < 0.05


def test_banded_layout_equals_default(blobs, arr):
    """boundary_prefix completes the J=2 band by (da + db) * 0.5, the
    tiers' mean: 2 frames of it equal the default layout's within 2e-5."""
    banded = nhp.build_nh_pieces_arrays(blobs[1], tets_per_piece=128,
                                        boundary_prefix=True, device="cpu")
    assert banded.r2 > 0 and banded.tier_counts
    params = tt.PhysicsParams(num_substeps=5)
    runs = [_run(tt.init_state(blobs[1], "cpu"), a, params,
                 tt.Controls.none("cpu"), 2) for a in (arr, banded)]
    np.testing.assert_allclose(runs[1].pos.numpy(), runs[0].pos.numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("boundary_prefix", [False, True])
def test_replicas_bitwise_equal(blobs, arr, boundary_prefix):
    """After a frame in the packed form, every instance of a particle holds
    the bits of its first instance, in position and velocity."""
    a = (nhp.build_nh_pieces_arrays(blobs[1], tets_per_piece=128,
                                    boundary_prefix=True, device="cpu")
         if boundary_prefix else arr)
    pack, step, _, _ = nhp.make_nh_pieces_stepper(a)
    params = tt.PhysicsParams(num_substeps=5)
    packed = step(pack(tt.init_state(blobs[1], "cpu"), params), params,
                  tt.Controls.none("cpu"))
    g2l = a.g2l_flat.long()
    real = g2l < a.num_particles
    owner = a.owner_inst.long()[g2l[real]]
    assert int((torch.arange(len(g2l))[real] != owner).sum()) > 100
    for plane in packed:
        flat = plane.reshape(-1)
        assert torch.equal(flat[real], flat[owner])


def test_world_body_pieces(blobs):
    """World(device="cpu").add_body(..., engine="nh_pieces"): pins baked in,
    a grab, diagnostics without a volume error (the JAX package's
    diagnostics raise on this body, ROADMAP Queue 3), smooth normals, and
    no kernel launch on the CPU."""
    nhp.launch_count = 0
    world = tt.World(tt.PhysicsParams(num_substeps=5), device="cpu")
    mesh = tt.with_boundary_surface(blobs[1])
    body = world.add_body(mesh, engine="nh_pieces", pinned=[0])
    assert isinstance(body.arrays, nhp.NHPiecesArrays)
    assert float(body.arrays.inv_mass[0]) == 0.0
    pid = body.start_grab([0.0, 1.2, 0.0])
    body.move_grabbed([0.0, 1.25, 0.0])
    world.step(2)
    np.testing.assert_array_equal(body.positions[pid], np.float32([0, 1.25, 0]))
    np.testing.assert_array_equal(body.positions[0], mesh.verts[0])
    verts, normals, _ = body.surface_mesh()
    assert np.isfinite(verts).all()
    assert np.abs(np.linalg.norm(normals, axis=1) - 1).max() < 1e-4
    d = world.diagnostics()["body0"]
    assert set(d) == {"kinetic_energy", "max_speed", "min_height", "nan"}
    s = body.state
    im = body.arrays.inv_mass
    ke = 0.5 * (torch.where(im > 0, 1 / im, 0.0) * (s.vel ** 2).sum(-1)).sum()
    assert d["kinetic_energy"] == pytest.approx(float(ke), rel=1e-5)
    assert not d["nan"] and d["min_height"] == float(s.pos[:, 1].min())
    assert nhp.launch_count == 0


def test_frame_work_counts(arr):
    """The bound's inputs: 420 flops per live tet and substep (padded
    slots, half of cons at 987,090 tets, not counted); per substep the
    bytes the frame must move: 15 planes of B*rp floats (the state in and
    out, movw, pid, lane_bnd), the live counts and 72 bytes of tables per
    live tet, and the completion's reads across pieces (none of a J=2 band
    in the default layout); at the 987,090-tet blob's shape (512 pieces,
    rp = 1,152, 30 sub-levels) 0.41 GFLOP, and about 106.5 MB per substep
    before its own completion's reads."""
    one = tt.PhysicsParams(num_substeps=1)
    assert nhp.frame_flops(arr, one) == 420 * 960
    tier = arr.lane_bnd >= 0
    count = arr.bnd_count[arr.lane_bnd[tier].long()]
    assert arr.r2 == 0 and int(tier.sum()) > 0
    assert nhp.frame_bytes(arr, tt.PhysicsParams(num_substeps=5)) == 5 * (
        60 * arr.B * arr.rp + 4 * arr.l_max * arr.B + 72 * 960
        + 4 * int(tier.sum()) + 28 * int(count.sum()))
    big = dataclasses.replace(arr, num_tets=987_090, B=512, rp=1152, l_max=30)
    assert 0.41e9 < nhp.frame_flops(big, one) < 0.42e9
    assert 106e6 < nhp.frame_bytes(big, one) < 107e6


def test_convert_round_trip(blobs, arr):
    """A JAX-built NHPiecesArrays, its fields as numpy, becomes the port's
    tables (live counts derived), equal to the port's own build."""
    ref = jnh.build_nh_pieces_arrays(blobs[0], tets_per_piece=128)
    got = convert.nh_pieces_arrays_from_numpy("cpu", **{
        f.name: (np.asarray(getattr(ref, f.name))
                 if hasattr(getattr(ref, f.name), "shape")
                 else getattr(ref, f.name))
        for f in dataclasses.fields(ref)})
    for f in dataclasses.fields(arr):
        a, b = getattr(arr, f.name), getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_non_cpu_tensor_goes_to_the_kernel(arr):
    """A tensor on any device but the CPU goes to the CUDA wrapper, which
    refuses a device it cannot launch on instead of taking the plain
    path."""
    assert tt.get_engine("nh_pieces") is nhp
    meta = [torch.zeros(arr.B, arr.rp, device="meta") for _ in range(6)]
    gid, gpos = tt.Controls.none("cpu").grab_id, tt.Controls.none("cpu").grab_pos
    with pytest.raises(ValueError, match="runs on CUDA"):
        nhp.nh_pieces_frame(meta, arr.to("meta"), tt.PhysicsParams(),
                            gid[None], gpos.reshape(1, 3))
