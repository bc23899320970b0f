"""tetsim_torch's polar pieces engine vs tetsim_tpu: the host schedule's
tables equal the JAX package's exactly, and the plain twin of the solve,
with the torch phases around it, follows the JAX XLA polar engine.

The JAX pieces kernel K6 is never run here (in interpret mode it takes
minutes on the CPU); the XLA polar engine is the oracle, as in
tests/test_polar_pieces.py.  All on the 960-tet ellipsoid blob of the JAX
tests."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu import diag as jdiag
from tetsim_tpu.kernels import polar_pieces as jpp
from tetsim_torch import convert, diag
from tetsim_torch.kernels import polar_pieces as pp

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BLOB = dict(n=8, radii=(0.4, 0.3, 0.35), center=(0.0, 0.8, 0.0))


@pytest.fixture(scope="module")
def blobs():
    return ts.ellipsoid_mesh(**BLOB), tt.ellipsoid_mesh(**BLOB)


@pytest.fixture(scope="module")
def xla_frame():
    return jax.jit(ts.get_engine("polar").step_frame)


@pytest.fixture(scope="module")
def arr(blobs):
    return pp.build_pieces_arrays(blobs[1], tets_per_piece=128, device="cpu")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        f"{what}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
    assert np.array_equal(a, b), f"{what} differs"


@pytest.mark.parametrize("boundary_prefix", [False, True])
@pytest.mark.parametrize("tpp", [128, 512])
def test_schedule_tables_equal(blobs, tpp, boundary_prefix):
    ref = jpp.build_pieces_schedule(blobs[0], tets_per_piece=tpp,
                                    boundary_prefix=boundary_prefix)
    port = pp.build_pieces_schedule(blobs[1], tets_per_piece=tpp,
                                    boundary_prefix=boundary_prefix)
    for f in dataclasses.fields(port):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, np.ndarray):
            _same(a, b, f.name)
        else:
            assert a == b, f.name
    if tpp == 512 and boundary_prefix:  # 2 pieces: partner completion only
        assert port.r2 and not port.tier_counts and port.rb < port.rp


def _run(state, arr, params, controls, frames):
    for _ in range(frames):
        state, diags = pp.step_frame(state, arr, params, controls)
    assert torch.isnan(diags).all() and diags.shape == (params.num_substeps,)
    return state


def _xla(blob, frame, params, controls, frames):
    arrx = ts.build_arrays(blob, coloring=None)
    s = ts.init_state(blob)
    for _ in range(frames):
        s, _ = frame(s, arrx, params, controls)
    return s


def test_twin_matches_xla_polar(blobs, xla_frame, arr):
    """3 frames at 5 substeps from rest: positions and quaternions within
    2e-5 of the XLA polar engine (its tolerance against K6,
    tests/test_polar_pieces.py)."""
    params = ts.PhysicsParams(num_substeps=5)
    ref = _xla(blobs[0], xla_frame, params, ts.Controls.none(), 3)
    got = _run(tt.init_state(blobs[1], "cpu"), arr, tt.PhysicsParams(num_substeps=5),
               tt.Controls.none("cpu"), 3)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), atol=2e-5)
    np.testing.assert_allclose(got.quats.numpy(), np.asarray(ref.quats),
                               atol=2e-5)
    assert got.pos[:, 1].min() < blobs[1].verts[:, 1].min()  # it fell


def test_grab_matches_xla_polar(blobs, xla_frame, arr):
    """With a grab: positions within 1e-4 (the JAX test's bound: the pin
    concentrates strain, which amplifies the cross-piece accumulation
    order), the grabbed particle on its target."""
    target = np.float32([0.1, 1.1, 0.0])
    params = ts.PhysicsParams(num_substeps=5)
    ref = _xla(blobs[0], xla_frame, params,
               ts.Controls(grab_id=np.int32(3), grab_pos=target), 3)
    controls = tt.Controls(grab_id=torch.tensor(3, dtype=torch.int32),
                           grab_pos=torch.tensor(target))
    got = _run(tt.init_state(blobs[1], "cpu"), arr,
               tt.PhysicsParams(num_substeps=5), controls, 3)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), atol=1e-4)
    np.testing.assert_array_equal(got.pos[3].numpy(), target)


@pytest.mark.parametrize("tpp", [128, 512])
def test_banded_layout_equals_default(blobs, tpp):
    """boundary_prefix completes the J=2 band by one partner gather: 2
    frames of it equal the default layout's within 2e-5."""
    params = tt.PhysicsParams(num_substeps=5)
    runs = []
    for bp in (False, True):
        a = pp.build_pieces_arrays(blobs[1], tets_per_piece=tpp,
                                   boundary_prefix=bp, device="cpu")
        runs.append(_run(tt.init_state(blobs[1], "cpu"), a, params,
                         tt.Controls.none("cpu"), 2))
    np.testing.assert_allclose(runs[1].pos.numpy(), runs[0].pos.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(runs[1].quats.numpy(), runs[0].quats.numpy(),
                               atol=2e-5)


def test_replicas_bitwise_equal(blobs):
    """After a frame in the packed form, every instance of a particle holds
    the bits of its first instance, in position and velocity."""
    a = pp.build_pieces_arrays(blobs[1], tets_per_piece=128,
                               boundary_prefix=True, device="cpu")
    pack, step, _, _ = pp.make_pieces_stepper(a)
    params = tt.PhysicsParams(num_substeps=5)
    packed = step(pack(tt.init_state(blobs[1], "cpu"), params), params,
                  tt.Controls.none("cpu"))
    g2l = a.g2l_flat.long()
    real = g2l < a.num_particles
    owner = a.owner_inst.long()[g2l[real]]
    # lanes that are a second or later instance of their particle
    assert int((torch.arange(len(g2l))[real] != owner).sum()) > 100
    for plane in packed[:6]:
        flat = plane.reshape(-1)
        assert torch.equal(flat[real], flat[owner])


def test_world_body_pieces(blobs):
    """World(device="cpu").add_body(..., engine="polar_pieces"): pins baked
    in, a grab, diagnostics with the JAX package's keys and values, rotated
    normals refused, and no kernel launch on the CPU."""
    pp.launch_count = 0
    world = tt.World(tt.PhysicsParams(num_substeps=5), device="cpu")
    mesh = tt.with_boundary_surface(blobs[1])
    body = world.add_body(mesh, engine="polar_pieces", pinned=[0])
    assert isinstance(body.arrays, pp.PiecesArrays)
    assert float(body.arrays.inv_mass[0]) == 0.0
    pid = body.start_grab([0.0, 1.2, 0.0])
    body.move_grabbed([0.0, 1.25, 0.0])
    world.step(2)
    np.testing.assert_array_equal(body.positions[pid], np.float32([0, 1.25, 0]))
    np.testing.assert_array_equal(body.positions[0], mesh.verts[0])
    verts, normals, tris = body.surface_mesh()
    assert verts.shape[0] == mesh.num_surface_verts and np.isfinite(normals).all()
    with pytest.raises(ValueError, match="polar engine"):
        body.surface_mesh(normals="rotated")
    d = world.diagnostics()["body0"]
    jarr = jpp.build_pieces_arrays(ts.ellipsoid_mesh(**BLOB), pinned=[0])
    s = body.state
    jstate = ts.SimState(pos=s.pos.numpy(), prev_pos=s.prev_pos.numpy(),
                         vel=s.vel.numpy(), quats=s.quats.numpy())
    ref = jdiag.summarize(jstate, jarr, np.asarray(body.last_diag))
    assert set(d) == set(ref) == {"kinetic_energy", "max_speed", "min_height",
                                  "nan"}
    for k in ("kinetic_energy", "max_speed", "min_height"):
        assert d[k] == pytest.approx(ref[k], rel=1e-5), k
    assert pp.launch_count == 0


def test_frame_work_counts(blobs, arr):
    """The bound's inputs: per live tet 1,627 flops and 116 bytes per
    substep, beside the planes; at the 987,090-tet blob (512 pieces of
    rp = 1,152 lanes) about 1.6 GFLOP and 129 MB per substep."""
    one = tt.PhysicsParams(num_substeps=1)
    assert pp.frame_flops(arr, one) == 960 * (391 + 136 * 9 + 12)
    assert pp.frame_bytes(arr, tt.PhysicsParams(num_substeps=5)) == 5 * (
        24 * arr.B * arr.rp + 116 * 960)
    big = dataclasses.replace(arr, num_tets=987_090, B=512, rp=1152)
    assert 1.60e9 < pp.frame_flops(big, one) < 1.61e9
    assert 128e6 < pp.frame_bytes(big, one) < 130e6


def test_convert_round_trip(blobs, arr):
    """A JAX-built PiecesArrays, its fields as numpy, becomes the port's
    tables, equal to the port's own build."""
    ref = jpp.build_pieces_arrays(blobs[0], tets_per_piece=128)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = convert.pieces_arrays_from_numpy(
        "cpu", **{k: np.asarray(v) if hasattr(v, "shape") else v
                  for k, v in fields.items()})
    for f in dataclasses.fields(arr):
        a, b = getattr(arr, f.name), getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert got.to("cpu").ids.device.type == "cpu"
    with pytest.raises(ValueError, match="fields"):
        convert.pieces_arrays_from_numpy("cpu", ids=np.zeros(1))


def test_non_cpu_tensor_goes_to_the_kernel(arr):
    """A tensor on any device but the CPU goes to the CUDA wrapper, which
    refuses a device it cannot launch on instead of taking the plain path;
    the registry resolves both pieces engines."""
    assert tt.get_engine("polar_pieces") is pp
    meta = [torch.zeros(arr.B, arr.rp, device="meta") for _ in range(3)]
    q = torch.zeros(4, arr.B, arr.rt, device="meta")
    with pytest.raises(ValueError, match="run on CUDA"):
        pp.pieces_solve(*meta, q, arr.to("meta"))
