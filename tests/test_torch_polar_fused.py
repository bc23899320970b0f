"""tetsim_torch's FusedPolarBody, BatchedBody and their frame function on the
CPU, held against tetsim_tpu's FusedPolarBody in Pallas interpret mode.

On the CPU the frame runs ``polar_frame_reference``, the plain twin of the
CUDA kernel ``kernels/csrc/polar_frame.cu``; the kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against that twin."""
import inspect

import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels.polar_fused import FusedPolarBody as JaxFusedPolarBody
from tetsim_tpu.world import World as JaxWorld
from tetsim_torch.kernels import polar_fused
from tetsim_torch.kernels.polar_fused import FusedPolarBody
from tetsim_torch.solvers import polar as tpolar
from tetsim_torch.world import BatchedBody

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BOX = dict(cell=0.25, origin=(-0.3, 0.5, -0.4))  # tests/test_polar_fused.py
PINNED = [12, 27, 42]  # three particles of the top face (y = 1.0)
GRAB_BODY, GRAB_PID = 2, 5
LIFT = np.float32([0.0, 0.05, 0.0])


def _mesh(pkg):
    return pkg.grid_mesh(3, 2, 4, **BOX)


@pytest.fixture(scope="module")
def jax_run():
    """One interpret-mode run of the JAX kernel: 8 jittered bodies, 3 pinned
    particles, body 2's particle 5 held 5 cm above its start, 2 frames x 5
    substeps."""
    body = JaxFusedPolarBody(_mesh(ts), num_bodies=8, interpret=True,
                             jitter=0.1, pinned=PINNED)
    start = body.positions()
    body.set_grab(GRAB_BODY, GRAB_PID, start[GRAB_BODY, GRAB_PID] + LIFT)
    body.step(ts.PhysicsParams(num_substeps=5), frames=2)
    return start, body.positions(), body.quaternions(), body.velocities()


def _port_run(frames=2):
    body = FusedPolarBody(_mesh(tt), 8, jitter=0.1, pinned=PINNED,
                          device="cpu")
    start = body.positions()
    count = polar_fused.launch_count
    body.set_grab(GRAB_BODY, GRAB_PID, start[GRAB_BODY, GRAB_PID] + LIFT)
    body.step(tt.PhysicsParams(num_substeps=5), frames=frames)
    assert polar_fused.launch_count == count  # the CPU never launches the kernel
    return start, body


def test_fused_matches_jax_fused(jax_run):
    """8 bodies: positions and quaternions 2e-5, velocities 2e-2
    (tests/test_polar_fused.py)."""
    ref_start, ref_pos, ref_q, ref_vel = jax_run
    start, body = _port_run()
    np.testing.assert_array_equal(start, ref_start)  # the same jitter draws
    pos, quats = body.positions(), body.quaternions()
    assert pos.shape == (8, 60, 3) and quats.shape == (8, 144, 4)
    np.testing.assert_allclose(pos, ref_pos, atol=2e-5)
    np.testing.assert_allclose(quats, ref_q, atol=2e-5)
    np.testing.assert_allclose(body.velocities(), ref_vel, atol=2e-2)


def test_fused_grab_and_pins(jax_run):
    start, body = _port_run()
    pos = body.positions()
    np.testing.assert_array_equal(pos[GRAB_BODY, GRAB_PID],
                                  start[GRAB_BODY, GRAB_PID] + LIFT)
    np.testing.assert_array_equal(pos[:, PINNED], start[:, PINNED])
    assert np.abs(pos - start).max() > 1e-3  # the rest hangs
    body.end_grab(GRAB_BODY)
    assert int(body.grab_id[GRAB_BODY, 0]) == -1
    with pytest.raises(IndexError):
        body.set_grab(8, 0, [0, 0, 0])


def test_batched_body_equals_fused_bitwise():
    """BatchedBody (the flat layout) starts where FusedPolarBody starts,
    the same jitter draws, and steps to the same bits; its grab takes a
    flat particle id."""
    params = tt.PhysicsParams(num_substeps=5)
    fused = FusedPolarBody(_mesh(tt), 8, jitter=0.1, device="cpu")
    flat = BatchedBody(_mesh(tt), 8, jitter=0.1, device="cpu")
    start = fused.positions()
    np.testing.assert_array_equal(flat.positions, start)
    np.testing.assert_array_equal(flat.flat_mesh.verts, start.reshape(-1, 3))
    target = start[GRAB_BODY, GRAB_PID] + LIFT
    fused.set_grab(GRAB_BODY, GRAB_PID, target)
    assert flat.grab_particle(GRAB_BODY * 60 + GRAB_PID, target) == GRAB_BODY
    fused.step(params, frames=2)
    flat.step(params)
    flat.step(params)
    assert torch.equal(flat.pos, fused.pos)
    assert torch.equal(flat.quats, fused.quats)
    assert flat.start_grab(4, flat.positions[4, 7]) == 7


def test_reference_equals_substep_per_body():
    """The batched frame is the single-body substep applied num_substeps
    times to each body, with each body's own grab."""
    mesh = tt.grid_mesh(2, 1, 1, cell=0.3, origin=(0.0, 0.4, 0.0))
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    params = tt.PhysicsParams(num_substeps=3)
    rng = np.random.RandomState(3)
    pos = torch.as_tensor(
        (mesh.verts[None] + rng.uniform(0, 0.2, (3, 1, 3))).astype(np.float32))
    vel = torch.as_tensor(rng.normal(0, 0.5, pos.shape).astype(np.float32))
    quats = torch.zeros(3, mesh.num_tets, 4)
    quats[..., 3] = 1.0
    gid = torch.tensor([[-1], [4], [-1]], dtype=torch.int32)
    gpos = torch.tensor([[[0, 0, 0]], [[0.1, 1.0, 0.2]], [[0, 0, 0]]],
                        dtype=torch.float32)
    out = polar_fused.polar_frame(pos, vel, quats, arr, params, gid, gpos)
    for b in range(3):
        state = tt.SimState(pos=pos[b], prev_pos=pos[b], vel=vel[b],
                            quats=quats[b])
        ctrl = tt.Controls(grab_id=gid[b, 0], grab_pos=gpos[b, 0])
        for _ in range(params.num_substeps):
            state, _ = tpolar.substep(state, arr, params, params.dt, ctrl)
        want_all = (state.pos, state.prev_pos, state.vel, state.quats)
        for got, want in zip(out, want_all):
            torch.testing.assert_close(got[b], want, rtol=0, atol=1e-6)


def test_shared_memory_capacity_check():
    """A body must fit one block's shared memory: 12^3 cubes fit, 40^3 not;
    the dragon's nine planes take 44 KB."""
    FusedPolarBody(tt.grid_mesh(12, 12, 12, cell=0.08), 2, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        FusedPolarBody(tt.grid_mesh(40, 40, 40, cell=0.02), 2, device="cpu")
    assert polar_fused.smem_bytes(1234) == 4 * 9 * 1234


def test_frame_work_counts():
    """The bound's counts for one dragon frame at 20 substeps."""
    arr = tt.build_arrays(tt.load_dragon(), coloring=None, device="cpu")
    params = tt.default_gpu_params()
    per_tet = 391 + 136 * 9
    assert polar_fused.frame_flops(arr, params, 1) == 20 * (
        3840 * per_tet + 19 * 1234 + 12 * 3840)
    assert polar_fused.frame_flops(arr, params, 8) == 8 * polar_fused.frame_flops(
        arr, params, 1)
    assert int((arr.inc_idx >= 0).sum()) == 4 * 3840  # live entries
    assert polar_fused.frame_bytes(arr, 1, 1) == (
        2 * 12 * 1234 + 16 * 3840 + 3 * 12 * 1234 + 16 * 3840
        + 68 * 3840 + 8 * 1234 + 4 * 4 * 3840 + 16)


def test_non_cpu_tensors_go_to_the_kernel():
    """A state on any device other than the CPU goes to the kernel, which
    refuses a device it cannot launch on instead of running the plain
    path."""
    m = tt.grid_mesh(1, 1, 1)
    arr = tt.build_arrays(m, coloring=None, device="meta")
    state = tt.init_state(m, "meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tpolar.step_frame(state, arr, tt.PhysicsParams(),
                          tt.Controls.none("meta"))


def test_add_body_batch_defaults_are_jax_s():
    """add_body_batch's signature and defaults are the JAX package's; the
    default pair (polar, flat) gives a BatchedBody, (polar, fused) a
    FusedPolarBody, and both step through World."""
    want = inspect.signature(JaxWorld.add_body_batch).parameters
    got = inspect.signature(tt.World.add_body_batch).parameters
    assert list(got) == list(want)
    assert {k: v.default for k, v in got.items()} == {
        k: v.default for k, v in want.items()}
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    flat = world.add_body_batch(_mesh(tt), 2)
    fused = world.add_body_batch(_mesh(tt), 2, engine="polar", backend="fused")
    assert isinstance(flat, BatchedBody) and type(fused) is FusedPolarBody
    world.step(2)
    assert torch.equal(flat.pos, fused.pos)
    d = world.diagnostics()
    assert d["body0"] == d["body1"] and d["body0"]["batch"] == 2
    assert not d["body0"]["nan"]
