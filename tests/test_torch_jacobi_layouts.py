"""How polar_jacobi's one-launch frame lays its work out, in plain torch.

``csrc/polar_jacobi.cu`` runs a frame as one cooperative launch: a predict
phase, then per substep a tet pass and a particle pass, each dealing its
items to the grid in chunks of 32 (the kernel's ``for_items``, modelled
here by ``item_plan``); the tet pass puts each corner's delta at its place
in its particle's row (``polar_jacobi.corner_tables``), and the particle
pass sums its row and writes each particle's prediction for the next
substep.  These tests check that plan (every tet and particle of B = 1 and
8 bodies of ``grid_mesh(20, 20, 20)`` exactly once, spread evenly over the
blocks), the corner tables against ``inc_idx``, and a plain-torch frame in
that dataflow, bitwise ``polar_jacobi.jacobi_frame_reference``, which
``tests/test_torch_large_body.py`` holds to the JAX polar engine.  The
kernel's own lanes per particle and threads per block are
``polar_jacobi.GROUP`` and ``THREADS``, which its library checks against
the ``.cu`` file when it is built."""
import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import polar_jacobi
from tetsim_torch.solvers import common, polar
from tetsim_torch.utils import mat3

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

GRID6 = dict(cell=0.1, origin=(-0.3, 0.2, -0.3))  # test_torch_large_body's


def item_plan(num_items: int, grid: int, group: int = 1) -> list:
    """How a pass of ``num_items`` items runs on a grid of ``grid`` blocks,
    ``group`` lanes to an item, as ``for_items`` in csrc/polar_jacobi.cu
    deals them: (block, warp, first lane, round) of every item in order.
    Chunk j of 32 // group items (a warp's) falls to block j % grid, warp
    (j // grid) % (THREADS // 32), in round j // (grid * THREADS // 32);
    item i takes lanes group * (i % (32 // group)) onwards.  The predict
    phase and the tet pass take one lane an item, the particle pass
    ``GROUP``."""
    warps, per_chunk = polar_jacobi.THREADS // 32, 32 // group
    return [(j % grid, (j // grid) % warps, group * (i % per_chunk),
             j // (grid * warps))
            for i in range(num_items) for j in (i // per_chunk,)]


@pytest.mark.parametrize("bodies", [1, 8])
def test_item_plan_takes_every_item_once(bodies):
    """Each tet (a lane each) and particle (GROUP lanes each) of B bodies
    of grid_mesh(20, 20, 20) falls to one (block, warp, first lane, round)
    of grids of 1, 3 and 4 blocks per SM on 132 SMs, that slot gives the
    item back as the kernel computes it, and the blocks' chunk counts
    differ by at most one."""
    m, n = 48_000 * bodies, 21 ** 3 * bodies
    warps = polar_jacobi.THREADS // 32
    for grid in (132, 396, 528):
        for items, group in ((m, 1), (n, polar_jacobi.GROUP)):
            per_chunk = 32 // group
            plan = item_plan(items, grid, group)
            assert len(plan) == items
            assert len(set(plan)) == items
            for i, (block, warp, lane, rnd) in enumerate(plan[::97]):
                assert 0 <= block < grid and 0 <= warp < warps
                assert lane % group == 0 and lane < 32
                j = block + grid * (warp + warps * rnd)
                assert per_chunk * j + lane // group == 97 * i
            chunks = np.bincount([p[0] for p in plan[::per_chunk]],
                                 minlength=grid)
            assert chunks.max() - chunks.min() <= 1


@pytest.mark.parametrize("dims", [(6, 6, 6), (20, 20, 20)])
def test_corner_tables_invert_inc_idx(dims):
    """Each corner 4 t + k of grid_mesh(*dims) has the place j N + p where
    inc_idx[p, j] is that corner, every place of a live entry is taken
    once, and inc_count counts each row's live entries."""
    mesh = tt.grid_mesh(*dims, **GRID6)
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    n, k = arr.inc_idx.shape
    slots, count = polar_jacobi.corner_tables(arr.inc_idx, mesh.num_tets)
    assert slots.shape == (mesh.num_tets, 4) and slots.dtype == torch.int32
    flat = slots.reshape(-1).long()
    j, p = flat // n, flat % n
    assert torch.equal(arr.inc_idx[p, j].long(), torch.arange(flat.numel()))
    assert flat.unique().numel() == flat.numel()
    assert torch.equal(count.long(), (arr.inc_idx >= 0).sum(1))
    assert int(count.sum()) == 4 * mesh.num_tets


def _plan_order(items: int, grid: int, group: int) -> torch.Tensor:
    """The items in the order the grid's threads take them: by round, then
    block, warp and lane."""
    plan = item_plan(items, grid, group)
    return torch.tensor(sorted(range(items), key=lambda i: (
        plan[i][3], plan[i][0], plan[i][1], plan[i][2])))


def tet_pass(pred, quats, arr, iters):
    """``polar.solve_shape_match``'s tets term by term on the predicted
    positions: the new quaternions and the weighted deltas [B, M, 4, 3]."""
    p = pred[..., arr.tets.long(), :]
    centroid = (((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :])
                + p[..., 3, :])[..., None, :] * 0.25
    pc = p - centroid
    rest_rot = polar.quat_rotate(arr.rest_centered, quats[..., None, :])
    a = mat3.outer_sum(pc, rest_rot)
    identity = torch.zeros_like(quats)
    identity[..., 3] = 1.0
    inc = polar.extract_rotation(a, identity, iters)
    quats = polar.quat_normalize(polar.quat_mul(inc, quats))
    delta = polar.quat_rotate(arr.rest_centered, quats[..., None, :]) - pc
    return delta * arr.rest_volume[..., None, None], quats


def dataflow_frame(pos, vel, quats, arr, params, gid, gpos, grid):
    """A frame in the kernel's dataflow: the predict phase (a lane a
    particle) and each particle pass (GROUP lanes a particle) take the
    particles in their ``item_plan`` order (a flat row per item); the tet
    pass reads only the prediction and the quaternions and stores each
    corner's delta at its ``corner_tables`` place of delta [B, K N]; a
    particle sums its inc_count deltas at p, N + p, ... in order, then
    collides, grabs, sets its velocity and writes its next prediction."""
    B, N, _ = pos.shape
    K = arr.inc_idx.shape[1]
    dt = params.dt
    first = _plan_order(B * N, grid, 1)
    order = _plan_order(B * N, grid, polar_jacobi.GROUP)
    body, v = order // N, order % N
    im = arr.inv_mass[v]
    slots, count = polar_jacobi.corner_tables(arr.inc_idx, arr.num_tets)
    movable = (im > 0.0)[:, None]
    den = torch.clamp(arr.inc_den[v], min=polar.EPS)[:, None]

    def rows(x, order=order):  # [B, N, 3] -> [B N, 3] in plan order
        return x.reshape(B * N, 3)[order]

    def back(x, order=order):  # the inverse
        out = torch.empty_like(x)
        out[order] = x
        return out.reshape(B, N, 3)

    start = pos
    pred = back(common.predict(rows(pos, first), rows(vel, first), dt,
                               params, inv_mass=arr.inv_mass[first % N])[0],
                first)
    for s in range(params.num_substeps):
        weighted, quats = tet_pass(pred, quats, arr, params.extract_iters)
        delta = torch.zeros((B, K * N, 3))
        delta[:, slots.reshape(-1).long()] = weighted.flatten(1, 2)
        num = torch.zeros((B * N, 3))
        for j in range(K):  # in row order, the live entries only
            num = num + torch.where((j < count[v])[:, None],
                                    delta[body, j * N + v], 0.0)
        x, x0 = rows(pred), rows(start)
        x = torch.where(movable, x + num / den, x)
        x = common.collide(x, x0, dt, params)
        for g in range(gid.shape[-1]):  # the last grab on a particle wins
            x = torch.where((gid[body, g] == v)[:, None], gpos[body, g], x)
        vel_rows = common.velocity_update(x, x0, dt)
        if s + 1 < params.num_substeps:
            pred = back(common.predict(x, vel_rows, dt, params,
                                       inv_mass=im)[0])
        prev, start = start, back(x)
    return start, prev, back(vel_rows), quats


@pytest.mark.parametrize("bodies,grid", [(1, 2), (8, 1)])
def test_dataflow_frame_is_the_reference_bitwise(bodies, grid):
    """On grid6 (343 particles, 1,296 tets), B jittered bodies with seeded
    velocities (numpy seed 12) and a grab on body 0 (and 5), 2 frames: the
    kernel's dataflow gives the plain frame's bits in positions, previous
    positions, velocities and quaternions (grid 1 takes the particles in 11
    rounds)."""
    mesh = tt.grid_mesh(6, 6, 6, **GRID6)
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    params = tt.PhysicsParams()
    rng = np.random.RandomState(12)
    rest = np.float32(mesh.verts)
    pos = torch.tensor(rest + rng.normal(0, 0.004, (bodies,) + rest.shape)
                       .astype(np.float32))
    vel = torch.tensor(rng.normal(0, 0.3, pos.shape).astype(np.float32))
    quats = torch.zeros((bodies, mesh.num_tets, 4))
    quats[..., 3] = 1.0
    gid = torch.full((bodies, 1), -1, dtype=torch.int32)
    gid[0, 0] = 7
    if bodies > 5:
        gid[5, 0] = mesh.num_particles - 1
    gpos = pos[torch.arange(bodies), gid[:, 0].clamp(min=0).long()][:, None] \
        + torch.tensor([0.03, 0.02, 0.0])
    ours = theirs = (pos, vel, quats)
    for _ in range(2):
        got = dataflow_frame(*ours, arr, params, gid, gpos, grid)
        want = polar_jacobi.jacobi_frame_reference(*theirs, arr, params, gid,
                                                   gpos)
        for name, x, y in zip(("pos", "prev", "vel", "quats"), got, want):
            assert torch.equal(x, y), name
        ours, theirs = ((r[0], r[2], r[3]) for r in (got, want))
    assert torch.equal(ours[0][0, 7], gpos[0, 0])
    assert (ours[0] != pos).any()


def test_one_launch_per_frame_and_cuda_only():
    """The frame is one launch; the CUDA wrapper refuses CPU tensors, and
    jacobi_frame on CPU tensors takes the twin without launching."""
    assert polar_jacobi.LAUNCHES_PER_FRAME == 1
    mesh = tt.grid_mesh(3, 3, 3, cell=0.25, origin=(-0.375, 0.5, -0.375))
    arr = tt.build_arrays(mesh, coloring=None, device="cpu")
    pos = torch.tensor(np.float32(mesh.verts))[None]
    vel = torch.zeros_like(pos)
    quats = torch.zeros((1, mesh.num_tets, 4))
    quats[..., 3] = 1.0
    gid = torch.full((1, 1), -1, dtype=torch.int32)
    gpos = torch.zeros((1, 1, 3))
    args = (pos, vel, quats, arr, tt.PhysicsParams(), gid, gpos)
    with pytest.raises(ValueError, match="runs on CUDA"):
        polar_jacobi._jacobi_frame_cuda(*args)
    before = polar_jacobi.launch_count
    out = polar_jacobi.jacobi_frame(*args)
    want = polar_jacobi.jacobi_frame_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    assert polar_jacobi.launch_count == before
