"""tetsim_torch's FusedGSBody and its frame function on the CPU, held against
tetsim_tpu's FusedGSBody in Pallas interpret mode.

On the CPU the frame runs ``gs_frame_reference``, the plain twin of the
CUDA kernel ``kernels/csrc/gs_frame.cu``; the kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against that twin."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels.gs_fused import FusedGSBody as JaxFusedGSBody
from tetsim_torch.kernels import gs_fused
from tetsim_torch.kernels.gs_fused import FusedGSBody
from tetsim_torch.solvers import neohookean as tnh

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BOX = dict(cell=0.5, origin=(-0.25, 0.1, -0.25))  # tests/test_gs_fused.py small
GRAB = (1, 5, [0.3, 1.2, 0.0])  # body, particle, target


@pytest.fixture(scope="module")
def jax_run():
    """One interpret-mode run of the JAX kernel: 4 jittered bodies, a grab
    on body 1, 3 frames x 2 substeps."""
    body = JaxFusedGSBody(ts.grid_mesh(1, 1, 1, **BOX), num_bodies=4,
                          interpret=True, jitter=0.2)
    body.set_grab(*GRAB)
    body.step(ts.PhysicsParams(num_substeps=2), frames=3)
    return body.positions(), body.velocities()


def _port_run(frames=3, grab=True, num_bodies=4):
    body = FusedGSBody(tt.grid_mesh(1, 1, 1, **BOX), num_bodies=num_bodies,
                       jitter=0.2, device="cpu")
    if grab:
        body.set_grab(*GRAB)
    count = gs_fused.launch_count
    verr = body.step(tt.PhysicsParams(num_substeps=2), frames=frames)
    assert gs_fused.launch_count == count  # the CPU never launches the kernel
    return body, verr


def test_fused_matches_jax_fused(jax_run):
    """4 bodies: positions 2e-4, velocities 2e-2 (tests/test_gs_fused.py)."""
    ref_pos, ref_vel = jax_run
    body, verr = _port_run()
    pos, vel = body.positions(), body.velocities()
    assert pos.shape == (4, 8, 3) and verr.shape == (4, 2)
    np.testing.assert_allclose(pos, ref_pos, atol=2e-4)
    np.testing.assert_allclose(vel, ref_vel, atol=2e-2)


def test_fused_grab_per_body(jax_run):
    ref_pos, _ = jax_run
    body, _ = _port_run()
    pos = body.positions()
    b, pid, target = GRAB
    np.testing.assert_array_equal(pos[b, pid], np.float32(target))
    np.testing.assert_allclose(pos[b], ref_pos[b], atol=2e-4)
    assert not np.allclose(pos[0, pid], target, atol=1e-3)


def test_reference_equals_step_frame_per_body():
    """The batched frame is the single-body substep applied num_substeps
    times to each body, with each body's own grab."""
    mesh = tt.grid_mesh(2, 1, 1, cell=0.3, origin=(0.0, 0.4, 0.0))
    arr = tt.build_arrays(mesh, coloring="greedy", device="cpu")
    params = tt.PhysicsParams(num_substeps=3)
    rng = np.random.RandomState(3)
    pos = torch.as_tensor(
        (mesh.verts[None] + rng.uniform(0, 0.2, (3, 1, 3))).astype(np.float32))
    vel = torch.as_tensor(rng.normal(0, 0.5, pos.shape).astype(np.float32))
    gid = torch.tensor([[-1], [4], [-1]], dtype=torch.int32)
    gpos = torch.tensor([[[0, 0, 0]], [[0.1, 1.0, 0.2]], [[0, 0, 0]]],
                        dtype=torch.float32)
    out = gs_fused.gs_frame(pos, vel, arr, params, gid, gpos)
    for b in range(3):
        state = tt.SimState(pos=pos[b], prev_pos=pos[b], vel=vel[b],
                            quats=torch.zeros(mesh.num_tets, 4))
        ctrl = tt.Controls(grab_id=gid[b, 0], grab_pos=gpos[b, 0])
        errs = []
        for _ in range(params.num_substeps):
            state, verr = tnh.substep(state, arr, params, params.dt, ctrl)
            errs.append(verr)
        want_all = (state.pos, state.prev_pos, state.vel, torch.stack(errs))
        for got, want in zip(out, want_all):
            torch.testing.assert_close(got[b], want, rtol=0, atol=1e-6)


def test_shared_memory_capacity_check():
    """A body must fit one block's shared memory: 12^3 cubes fit, 40^3 not."""
    mid = FusedGSBody(tt.grid_mesh(12, 12, 12, cell=0.08, origin=(-0.48, 0.5, -0.48)),
                      num_bodies=8, device="cpu")
    assert gs_fused.smem_bytes(mid.mesh.num_particles) <= gs_fused.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        FusedGSBody(tt.grid_mesh(40, 40, 40, cell=0.02, origin=(0.0, 0.5, 0.0)),
                    num_bodies=8, device="cpu")
    # the dragon's nine planes take 44 KB
    assert gs_fused.smem_bytes(1234) == 4 * (9 * 1234 + 8)


def test_grab_api_and_bounds():
    body = FusedGSBody(tt.grid_mesh(1, 1, 1, **BOX), num_bodies=2, device="cpu")
    verts = tt.grid_mesh(1, 1, 1, **BOX).verts
    assert body.start_grab(1, verts[6] + 1e-3) == 6
    body.move_grabbed(1, [0.0, 2.0, 0.0])
    body.step(tt.PhysicsParams(num_substeps=2), frames=8)
    pos = body.positions()
    np.testing.assert_array_equal(pos[1, 6], np.float32([0.0, 2.0, 0.0]))
    assert np.isfinite(pos).all() and pos[0, :, 1].min() >= -1e-5
    body.end_grab(1)
    assert int(body.grab_id[1, 0]) == -1
    with pytest.raises(IndexError):
        body.set_grab(2, 0, [0, 0, 0])


def test_frame_params_are_f32_of_the_plain_path():
    params = tt.default_cpu_params()
    fp = gs_fused._frame_params(params)
    dt = params.dt
    assert np.float32(fp.dt) == dt
    assert np.float32(fp.gdt) == params.gravity * dt
    assert np.float32(fp.k_fric) == np.float32(1.0)  # dt * friction = 3.33
    assert np.float32(fp.dev_scale) == params.dev_compliance / (dt * dt)
    assert list(fp.wmin) == [-2.5, -1.0, -2.5] and list(fp.wmax) == [2.5, 10.0, 2.5]


def test_frame_work_counts():
    """The bound's counts for one dragon frame, ordered and greedy: the
    same work on either schedule, each tet's constants read once (the
    padded slots, 703 x 22 ordered and 32 x 228 greedy, add nothing)."""
    dragon = tt.load_dragon()
    params = tt.default_cpu_params()
    for coloring, slots in (("ordered", 703 * 22), ("greedy", 32 * 228)):
        arr = tt.build_arrays(dragon, coloring=coloring, device="cpu")
        assert arr.slot_valid.numel() == slots
        assert gs_fused.frame_flops(arr, params, 2) == 2 * 5 * (
            421 * 3840 + 13 * 1234)
        assert gs_fused.frame_bytes(arr, params, 1, 1) == (
            5 * 12 * 1234 + 4 * 5 + 16 + 73 * 3840 + 4 * 1234)
