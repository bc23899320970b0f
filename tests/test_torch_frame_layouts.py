"""How the dragon frame kernels lay their work out on the card, checked on
the CPU: the level walk of ``csrc/gs_frame.cu`` (K1) and the thread-block
cluster of ``csrc/polar_frame.cu`` (K2).

K2 runs one body on a cluster of cs blocks: every block predicts all
particles on its own replica of the planes, block r solves its range of
tets into a shared delta scratch (phase A), then sums the deltas of its
range of particles in ``inc_idx`` order, collides, grabs and writes the
result into every replica (phase B).  ``clustered_frame`` below does the
same in plain torch, block by block, and is held bitwise to the plain twin
``polar_frame_reference`` and, at the twin's tolerance, to the JAX
package's ``FusedPolarBody`` in interpret mode.  The last tests cover the
host work the two wrappers now do once instead of at every launch."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels.polar_fused import FusedPolarBody as JaxFusedPolarBody
from tetsim_torch.kernels import gs_fused, polar_fused
from tetsim_torch.kernels.batch import prepared
from tetsim_torch.solvers import common
from tetsim_torch.solvers import polar as tpolar
from tetsim_torch.utils import mat3

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BOX = dict(cell=0.25, origin=(-0.3, 0.5, -0.4))  # tests/test_polar_fused.py
PINNED = [12, 27, 42]
GRAB_BODY, GRAB_PID = 2, 5
LIFT = np.float32([0.0, 0.05, 0.0])
DRAGON_M, DRAGON_N = 3840, 1234


@pytest.fixture(scope="module")
def dragon():
    return tt.load_dragon()


def test_walk_is_warp_for_the_ordered_schedule_block_for_greedy(dragon):
    """World.add_body's ordered schedule (703 levels of at most 22 tets)
    takes the warp walk; bench.py's greedy one (up to 228) the block
    walk; the warp holds a level of up to 32 slots."""
    ordered = tt.build_arrays(dragon, coloring="ordered", device="cpu")
    greedy = tt.build_arrays(dragon, coloring="greedy", device="cpu")
    assert tuple(ordered.slot_valid.shape) == (703, 22)
    assert tuple(greedy.slot_valid.shape) == (32, 228)
    assert gs_fused.walk(ordered.slot_valid.shape[1]) == "warp"
    assert gs_fused.walk(greedy.slot_valid.shape[1]) == "block"
    assert [gs_fused.walk(c) for c in (1, 32, 33, 256, 300)] == [
        "warp", "warp", "block", "block", "block"]
    assert set(gs_fused.WALKS) == {"warp", "block"}


def test_cluster_size_fills_one_wave():
    """16 blocks per body at B = 1 and 8, one at B = 132; a power of two,
    never 0, never above the card's largest cluster; with the clusters an
    H100 runs at once at 44 KB of shared memory a block (7 of 16 blocks),
    8 bodies take clusters of 8."""
    assert [polar_fused.cluster_size(b, 16) for b in (1, 8, 132)] == [16, 16, 1]
    assert polar_fused.cluster_size(9, 16) == 8  # 9 x 16 > 132
    assert polar_fused.cluster_size(1, 12) == 8
    h100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
    assert [polar_fused.cluster_size(b, 16, h100)
            for b in (1, 7, 8, 15, 16, 31, 132)] == [16, 16, 8, 8, 4, 2, 1]
    assert polar_fused.cluster_size(1, 16, {1: 1, 2: 0, 4: 0, 8: 0,
                                            16: 0}) == 1
    for max_cs in range(0, 17):
        for b in (1, 2, 3, 8, 9, 33, 66, 67, 132, 133, 500):
            cs = polar_fused.cluster_size(b, max_cs)
            assert cs >= 1 and cs & (cs - 1) == 0
            assert cs == 1 or (cs <= max_cs and b * cs <= polar_fused.SMS)


@pytest.mark.parametrize("cs", polar_fused.CLUSTER_SIZES)
@pytest.mark.parametrize("n", [DRAGON_M, DRAGON_N])
def test_split_covers_each_item_once(n, cs):
    """The dragon's tets (phase A) and particles (phase B) over the blocks
    of a cluster: each exactly once, in order, ceil(n / cs) a block."""
    ranges = polar_fused.split(n, cs)
    assert len(ranges) == cs
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert max(hi - lo for lo, hi in ranges) == -(-n // cs)


def _phase_a(pos, quats, arr, lo, hi, iters):
    """Block tets [lo, hi): their new quaternions and weighted deltas
    [B, 4 (hi - lo), 3], as solvers/polar.py solve_shape_match makes them."""
    tets = arr.tets[lo:hi].long()
    rest = arr.rest_centered[lo:hi]
    p = pos[..., tets, :]
    centroid = (((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :])
                + p[..., 3, :])[..., None, :] * 0.25
    pc = p - centroid
    a = mat3.outer_sum(pc, tpolar.quat_rotate(rest, quats[..., None, :]))
    identity = torch.zeros_like(quats)
    identity[..., 3] = 1.0
    inc = tpolar.extract_rotation(a, identity, iters)
    quats = tpolar.quat_normalize(tpolar.quat_mul(inc, quats))
    delta = tpolar.quat_rotate(rest, quats[..., None, :]) - pc
    w = arr.rest_volume[lo:hi]
    return quats, (delta * w[..., None, None]).flatten(-3, -2)


def _phase_b(pos, prev, delta, arr, lo, hi, params, gid, gpos):
    """Block particles [lo, hi): the sum of each one's incident deltas in
    inc_idx order, then collide, grab and velocity."""
    inc = arr.inc_idx[lo:hi]
    live = (inc >= 0)[..., None]
    contrib = delta[..., inc.clamp(min=0).long(), :]
    num = torch.zeros_like(pos)
    for k in range(inc.shape[1]):
        num = num + torch.where(live[:, k], contrib[..., k, :], 0.0)
    den = torch.clamp(arr.inc_den[lo:hi][..., None], min=tpolar.EPS)
    movable = (arr.inv_mass[lo:hi] > 0.0)[..., None]
    pos = torch.where(movable, pos + num / den, pos)
    pos = common.collide(pos, prev, params.dt, params)
    pos = common.grab_override(pos, gid - lo, gpos)
    return pos, common.velocity_update(pos, prev, params.dt)


def clustered_frame(pos, vel, quats, arr, params, gid, gpos, cs):
    """One frame as a cluster of cs blocks runs it (see the module
    docstring), each block with its own replica of pos and vel.  Returns
    (pos, prev_pos, vel, quats) and checks that the replicas agree."""
    b, n, m = pos.shape[0], arr.num_particles, arr.num_tets
    replicas = [(pos.clone(), vel.clone()) for _ in range(cs)]
    quats = quats.clone()
    for _ in range(params.num_substeps):
        predicted = [common.predict(x, v, params.dt, params,
                                    inv_mass=arr.inv_mass)
                     for x, v in replicas]
        delta = torch.full((b, 4 * m, 3), float("nan"))  # scratch in L2
        for r, (lo, hi) in enumerate(polar_fused.split(m, cs)):
            quats[:, lo:hi], delta[:, 4 * lo:4 * hi] = _phase_a(
                predicted[r][0], quats[:, lo:hi], arr, lo, hi,
                params.extract_iters)
        assert not delta.isnan().any()  # every tet wrote its deltas
        replicas = [(x.clone(), v.clone()) for x, _, v in predicted]
        for r, (lo, hi) in enumerate(polar_fused.split(n, cs)):
            x, prev, _ = predicted[r]
            xr, vr = _phase_b(x[:, lo:hi], prev[:, lo:hi], delta, arr, lo,
                              hi, params, gid, gpos)
            for rx, rv in replicas:  # into every replica
                rx[:, lo:hi], rv[:, lo:hi] = xr, vr
    for x, v in replicas[1:]:
        assert torch.equal(x, replicas[0][0]) and torch.equal(v, replicas[0][1])
    return replicas[0][0], predicted[0][1], replicas[0][1], quats


def _grid_start():
    body = polar_fused.FusedPolarBody(tt.grid_mesh(3, 2, 4, **BOX), 8,
                                      jitter=0.1, pinned=PINNED, device="cpu")
    start = body.positions()
    body.set_grab(GRAB_BODY, GRAB_PID, start[GRAB_BODY, GRAB_PID] + LIFT)
    return body


@pytest.fixture(scope="module")
def jax_run():
    """The JAX kernel in interpret mode on tests/test_torch_polar_fused.py's
    scene: 8 jittered boxes, 3 pinned particles, body 2's particle 5 held
    5 cm above its start, 2 frames x 5 substeps."""
    body = JaxFusedPolarBody(ts.grid_mesh(3, 2, 4, **BOX), num_bodies=8,
                             interpret=True, jitter=0.1, pinned=PINNED)
    start = body.positions()
    body.set_grab(GRAB_BODY, GRAB_PID, start[GRAB_BODY, GRAB_PID] + LIFT)
    body.step(ts.PhysicsParams(num_substeps=5), frames=2)
    return start, body.positions(), body.quaternions(), body.velocities()


@pytest.mark.parametrize("cs", [1, 4, 16])
def test_clustered_frame_matches_twin_and_jax(jax_run, cs):
    """The split frame gives the twin's bits after each of 2 frames, and
    is within the twin's bars of the JAX kernel: positions and
    quaternions 2e-5, velocities 2e-2 (test_fused_matches_jax_fused)."""
    ref_start, ref_pos, ref_q, ref_vel = jax_run
    body = _grid_start()
    np.testing.assert_array_equal(body.positions(), ref_start)
    params = tt.PhysicsParams(num_substeps=5)
    state = (body.pos, body.vel, body.quats)
    twin = state
    for _ in range(2):
        pos, _, vel, quats = clustered_frame(*state, body.arrays, params,
                                             body.grab_id, body.grab_pos, cs)
        want = polar_fused.polar_frame_reference(
            *twin, body.arrays, params, body.grab_id, body.grab_pos)
        for got, ref in zip((pos, vel, quats), (want[0], want[2], want[3])):
            assert torch.equal(got, ref)
        state = twin = (pos, vel, quats)
    np.testing.assert_allclose(pos.numpy(), ref_pos, atol=2e-5)
    np.testing.assert_allclose(quats.numpy(), ref_q, atol=2e-5)
    np.testing.assert_allclose(vel.numpy(), ref_vel, atol=2e-2)
    assert int(body.grab_id[GRAB_BODY, 0]) == GRAB_PID
    np.testing.assert_array_equal(pos[GRAB_BODY, GRAB_PID].numpy(),
                                  ref_start[GRAB_BODY, GRAB_PID] + LIFT)


@pytest.mark.parametrize("cs", [4, 16])
def test_clustered_frame_is_the_twin_on_the_dragon(dragon, cs):
    """The dragon (3,840 tets, 1,234 particles) at 5 substeps, 2 jittered
    bodies with a grab on body 1: one frame, bitwise the twin, prev_pos
    too."""
    body = polar_fused.FusedPolarBody(dragon, 2, jitter=0.2, device="cpu")
    body.set_grab(1, 100, body.positions()[1, 100] + LIFT)
    params = tt.PhysicsParams(num_substeps=5)
    args = (body.pos, body.vel, body.quats, body.arrays, params,
            body.grab_id, body.grab_pos)
    got = clustered_frame(*args, cs)
    want = polar_fused.polar_frame_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float((got[0] - body.pos).abs().max()) > 1e-3  # it moved


class _Lib:
    """A kernel library's prepare function as the wrappers call it."""

    def __init__(self, fail=()):
        self.calls, self.fail = [], set(fail)

    def k_prepare(self, n):
        self.calls.append(n)
        return 1 if n in self.fail else 0


def test_prepared_raises_the_shared_memory_attribute_only():
    """The dynamic shared-memory attribute is one value per kernel: it is
    set before the first launch on a device and again only for a larger
    body (a smaller one after a larger must not lower it), and a failed
    call is not remembered."""
    lib = _Lib(fail={700})
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert [prepared(lib, "k", d, n) for d, n in (
        (dev0, 1234), (dev0, 1234), (dev0, 2197), (dev0, 64), (dev0, 1234),
        (dev1, 64), (dev1, 700), (dev1, 700), (dev1, 100))] == [
        0, 0, 0, 0, 0, 0, 1, 1, 0]
    assert lib.calls == [1234, 2197, 64, 700, 700, 100]


def test_frame_params_are_built_once_per_set_of_values():
    """The launch structs are built once per set of parameter values, and
    anew after a field changes (PhysicsParams is mutable)."""
    params = tt.default_gpu_params()
    first = polar_fused._polar_params(params)
    assert polar_fused._polar_params(tt.default_gpu_params()) is first
    assert gs_fused._frame_params(params) is gs_fused._frame_params(params)
    params.friction = np.float32(30.0)
    changed = polar_fused._polar_params(params)
    assert changed is not first
    assert changed.k_fric == pytest.approx(
        float(np.minimum(np.float32(1.0), params.dt * params.friction)))
    params.world_max = np.array([1.0, 2.0, 3.0], np.float32)
    assert list(polar_fused._polar_params(params).wmax) == [1.0, 2.0, 3.0]
