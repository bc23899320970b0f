"""How the two Neo-Hookean kernels that walk a whole frame in one launch
lay it out on the card, checked on the CPU.

gs_levels (``csrc/gs_levels.cu``) runs a body's frame on one thread-block
cluster: the cs blocks split a level's slots, ceil(C / cs) in a row each,
with a cluster barrier between levels.  The tests hold
``gs_levels.level_plan`` to the schedule (every slot once) and run a plain
frame that solves each level a block's pass at a time, in that plan's
order, bitwise ``levels_frame_reference``.

K3s (``csrc/nh_stencil.cu``, the slab form of K3) runs the slabs of one
device in one cooperative launch and moves no boundary plane between them:
the thread that writes a vertex of a shared plane also writes the
neighbour slab's replica.  The tests hold the colour plan to the argument
that makes this exact (a colour group writes a shared plane on one side of
its boundary only) and run a plain slab sweep in that manner, bitwise the
sharded twin ``neohookean_grid.make_nh_sharded_step``; and they hold
``nh_stencil.slab_calls``, the launches of a mesh over several devices, to
the twin's exchange points.  The twins' agreement with the JAX package is
``tests/test_torch_large_body.py``'s and ``tests/test_torch_nh_grid_sharded.py``'s."""
import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import gs_levels
from tetsim_torch.kernels import nh_stencil as nh
from tetsim_torch.parallel import SlabMesh
from tetsim_torch.solvers import common, neohookean, neohookean_grid as nhg

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

CLUSTERS = (1, 2, 4, 8, 16)
SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
BOX = (8, 2, 2)


@pytest.fixture(scope="module")
def ordered():
    mesh = tt.grid_mesh(4, 4, 4, **SMALL)
    return mesh, tt.build_arrays(mesh, coloring="ordered", device="cpu")


def _covers_once(plan, valid, cs, width):
    slots = [slot for _, _, _, slot in plan]
    assert sorted(slots) == list(range(len(valid)))
    assert all(0 <= r < cs and 0 <= j < width for r, j, _, _ in plan)
    # a (block, thread, pass) takes one slot
    assert len({(r, j, p) for r, j, p, _ in plan}) == len(plan)
    assert sum(bool(v) for v in valid) <= len(slots)


@pytest.mark.parametrize("cs", CLUSTERS)
def test_level_plan_covers_each_slot_once(ordered, cs):
    """Every slot of every level of grid_mesh(4, 4, 4)'s ordered schedule,
    and of a level as wide as grid_mesh(20, 20, 20)'s widest (1,520 slots),
    falls to exactly one (block, thread, pass) of a cluster of cs blocks."""
    _, arr = ordered
    for valid in arr.slot_valid.tolist():
        _covers_once(gs_levels.level_plan(len(valid), cs), valid, cs,
                     gs_levels.THREADS)
    wide = [True] * 1520
    plan = gs_levels.level_plan(len(wide), cs)
    _covers_once(plan, wide, cs, gs_levels.THREADS)
    # each block's share in as few passes as its threads allow
    span = -(-1520 // cs)
    assert max(p for _, _, p, _ in plan) == -(-span // gs_levels.THREADS) - 1
    assert {r for r, _, _, _ in plan} == set(range(min(cs, 1520)))


def _chunked_frame(pos, vel, arr, params, gid, gpos, cs):
    """A frame that solves each level a block's pass at a time, in
    ``level_plan``'s order (block by block, pass by pass), each chunk's
    corners written back before the next is read; vol_err is summed per
    level over the slots as the twin sums it.  Returns (pos, prev, vel,
    vol_err) as ``levels_frame_reference``."""
    dt = params.dt
    L, C = arr.slot_valid.shape
    chunks = {}
    for r, _, p, slot in gs_levels.level_plan(C, cs):
        chunks.setdefault((r, p), []).append(slot)
    errs = []
    for _ in range(params.num_substeps):
        pos, prev, vel = common.predict(pos, vel, dt, params,
                                        inv_mass=arr.inv_mass)
        total = pos.new_zeros(pos.shape[0])
        for lev in range(L):
            verr = pos.new_zeros((pos.shape[0], C))
            for slots in chunks.values():
                s = torch.tensor(slots)
                s = s[arr.slot_valid[lev, s]]
                if not len(s):
                    continue
                ids = arr.slot_tets[lev, s].long()
                p = pos[:, ids]  # [B, c, 4, 3]
                delta, e = neohookean.solve_tet_batch(
                    p, arr.slot_inv_rest_pose[lev, s],
                    arr.slot_inv_rest_volume[lev, s],
                    arr.slot_inv_mass[lev, s], dt, params)
                pos = pos.clone()
                pos[:, ids.reshape(-1)] = (p + delta).flatten(1, 2)
                verr[:, s] = e
            total = total + torch.where(arr.slot_valid[lev], verr,
                                        0.0).sum(dim=-1)
        errs.append(total / arr.num_tets)
        pos = common.grab_override(common.collide(pos, prev, dt, params),
                                   gid, gpos)
        vel = common.velocity_update(pos, prev, dt)
    return pos, prev, vel, torch.stack(errs, dim=-1)


@pytest.mark.parametrize("cs", CLUSTERS)
def test_cluster_order_is_the_twin(ordered, cs):
    """A plain frame that takes each level's tets in the cluster's order, a
    chunk at a time, is bitwise levels_frame_reference after 2 frames of 2
    bodies with a grab, vol_err included; the kernel's own order of the
    volume sum (each virtual block's tree, then a strided sum) stays within
    1e-6 of it."""
    mesh, arr = ordered
    params = tt.PhysicsParams(num_substeps=3)
    rng = np.random.RandomState(cs)
    pos = torch.tensor(np.stack([mesh.verts] * 2)
                       + rng.normal(0, 0.01, (2,) + mesh.verts.shape)
                       .astype(np.float32))
    vel = torch.tensor(rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32))
    gid = torch.tensor([[7], [-1]], dtype=torch.int32)
    gpos = pos[:, 7][:, None] + torch.tensor([0.0, 0.05, 0.0])
    want = got = (pos, None, vel)
    for _ in range(2):
        want = gs_levels.levels_frame_reference(want[0], want[2], arr, params,
                                                gid, gpos)
        got = _chunked_frame(got[0], got[2], arr, params, gid, gpos, cs)
        for name, g, w in zip(("pos", "prev", "vel", "vol_err"), got, want):
            assert torch.equal(g, w), name
    assert torch.equal(got[0][0, 7], gpos[0, 0])
    # the kernel's sum: 256-slot trees per (level, 256 slots in a row), then
    # block 0's strided sum and its tree, as csrc/gs_levels.cu
    verr = torch.tensor(rng.normal(0, 1e-3, (arr.slot_valid.shape[0], 300))
                        .astype(np.float32))
    assert abs(float(_kernel_sum(verr) - verr.sum())) <= 1e-6


def _tree(x):
    """The block tree of 256 values: x[j] += x[j + s], s = 128 .. 1."""
    x = x.clone()
    s = x.shape[-1] // 2
    while s:
        x[..., :s] = x[..., :s] + x[..., s:2 * s]
        s //= 2
    return x[..., 0]


def _kernel_sum(verr):
    """vol_err's sum over one substep's [L, C] det F - 1 in the kernel's
    order."""
    t = gs_levels.THREADS
    L, C = verr.shape
    nblk = -(-C // t)
    rows = torch.nn.functional.pad(verr, (0, nblk * t - C)).reshape(L, nblk, t)
    part = _tree(rows).reshape(-1)
    acc = torch.zeros(t)
    for j0 in range(0, len(part), t):  # each thread a fixed stride
        chunk = part[j0:j0 + t]
        acc[:len(chunk)] = acc[:len(chunk)] + chunk
    return _tree(acc)


@pytest.mark.parametrize("lx", [2, 4, 14])
def test_groups_write_one_side_of_each_boundary(lx):
    """In each of the 12 colour groups (one type, one px) of a slab of lx
    cube columns, the tets reach vertex plane 0 (shared with the left
    neighbour) only where px = 0 and plane lx (shared with the right
    neighbour) only where px = 1: a group reads and writes each shared
    plane on one side of its boundary, so the other side's replica can take
    every write through in the same phase."""
    dims = (lx, 3, 2)
    mesh = tt.grid_mesh(*dims)
    arr = nhg.build_nh_grid_arrays(mesh, dims, device="cpu")
    gyz = (dims[1] + 1) * (dims[2] + 1)
    lanes = np.arange(nh.partial_blocks(dims) * nh.THREADS)
    for group in range(12):
        planes = set()
        for color in range(4 * group, 4 * group + 4):
            ids = nh.color_corners(dims, arr.corner_slab, color, lanes)
            planes |= set((ids[ids >= 0] // gyz).tolist())
        px = group % 2
        assert (0 in planes) == (px == 0) and (lx in planes) == (px == 1), \
            (group, sorted(planes))


def _write_through_frame(slab_pos, slab_vel, arr, d, params, gid, gpos,
                         through=True):
    """A frame of the slab state (nhg.nh_prepare's lists) in K3s's manner:
    each colour of the 48 on every slab's flat planes (a tet lane per
    ``color_corners``, written back as the twin's sweep adds its update),
    every update of a shared-plane vertex written at once into the
    neighbour's replica (``through``), no exchange; predict and collide as
    the twin's.  Returns the slab lists (pos, vel)."""
    lx, local = nhg._slab_geometry(arr.dims, d)
    gyz = (arr.dims[1] + 1) * (arr.dims[2] + 1)
    dt = params.dt
    im = torch.stack(nhg.slab_inv_mass(arr, d))  # [d, n]
    n = im.shape[1]
    pid = torch.arange(n)[None] + torch.arange(d)[:, None] * (lx * gyz)
    X, Y, Z = torch.stack(slab_pos).unbind(1)
    VX, VY, VZ = torch.stack(slab_vel).unbind(1)
    lanes = np.arange(nh.partial_blocks(local) * nh.THREADS)
    for _ in range(params.num_substeps):
        PX, PY, PZ = X, Y, Z
        X, Y, Z, VX, VY, VZ = nhg.predict_phase(im, X, Y, Z, VX, VY, VZ,
                                                params, dt)
        comps = [X.clone(), Y.clone(), Z.clone()]
        for color in range(nh.COLORS):
            ids = nh.color_corners(local, arr.corner_slab, color, lanes)
            ids = torch.tensor(ids[ids[:, 0] >= 0])
            pc = [[c[:, ids[:, k]] for c in comps] for k in range(4)]
            imc = [im[:, ids[:, k]] for k in range(4)]
            newp, _ = nhg._solve_color(pc, imc, arr.inv_rest_pose[color >> 3],
                                       arr.inv_rest_volume, dt,
                                       params.dev_compliance,
                                       params.vol_compliance)
            for k in range(4):
                plane = ids[:, k] // gyz
                left, right = plane == 0, plane == lx
                for c, comp in enumerate(comps):
                    new = pc[k][c] + (newp[k][c] - pc[k][c])
                    comp[:, ids[:, k]] = new
                    if through:
                        comp[:-1, ids[left, k] + lx * gyz] = new[1:, left]
                        comp[1:, ids[right, k] - lx * gyz] = new[:-1, right]
        X, Y, Z, VX, VY, VZ = nhg.collide_grab_phase(
            *comps, PX, PY, PZ, pid, params, dt, gid, gpos)
    return (list(torch.stack([X, Y, Z], dim=1)),
            list(torch.stack([VX, VY, VZ], dim=1)))


@pytest.mark.parametrize("d", [2, 4])
def test_write_through_is_the_sharded_twin(d):
    """On an 8x2x2 box in d slabs, seeded velocities and a grab lifting a
    vertex of the shared plane x = 4, 2 frames of K3s's write-through order
    are bitwise make_nh_sharded_step (with its 12 exchanges per substep),
    the two replicas of every shared plane equal after each frame; without
    the write-through they are not."""
    mesh = tt.grid_mesh(*BOX, cell=0.1, origin=(-0.4, 0.3, -0.1))
    arr = nhg.build_nh_grid_arrays(mesh, BOX, device="cpu")
    rng = np.random.RandomState(d)
    st = tt.init_state(mesh, "cpu")
    st = st.replace(vel=torch.tensor(rng.uniform(-0.5, 0.5, st.vel.shape)
                                     .astype(np.float32)))
    g = BOX[1] + 1
    vid = (4 * g + BOX[1]) * g + 1
    target = torch.tensor(np.float32(mesh.verts[vid] + [0.0, 0.02, 0.01]))
    ctl = tt.Controls(grab_id=torch.tensor(vid, dtype=torch.int32),
                      grab_pos=target)
    gid, gpos = common.norm_grabs(ctl)
    params = tt.PhysicsParams(num_substeps=2)
    slabs = SlabMesh(devices=["cpu"] * d)
    twin = nhg.make_nh_sharded_step(slabs, arr)
    lx = BOX[0] // d
    gyz = g * g
    want = got = nhg.nh_prepare(st, arr, slabs)
    for _ in range(2):
        start = got
        want, _ = twin(want, params, ctl)
        got = _write_through_frame(*got, arr, d, params, gid, gpos)
        for name, a, b in zip(("pos", "vel"), got, want):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        for i in range(1, d):
            assert torch.equal(got[0][i - 1][:, lx * gyz:],
                               got[0][i][:, :gyz])
    stale = _write_through_frame(*start, arr, d, params, gid, gpos,
                                 through=False)
    assert not all(torch.equal(x, y) for x, y in zip(stale[0], want[0]))
    out = nhg.nh_unprepare(got, arr, d, params)
    assert torch.equal(out.pos[vid], target)


@pytest.mark.parametrize("substeps", [1, 5])
def test_slab_calls_follow_the_twin(substeps):
    """K3s's launches per frame: one on a single device; over several
    devices, calls that cover every phase of the frame once, end only at
    colour-group boundaries, and exchange at the sharded twin's points
    ("left" where its colour plan flips to px = 1, "right" where it flips
    back and after the sweep), 12 per substep."""
    total = nh.frame_phases(substeps)
    assert total == 1 + substeps * (nh.COLORS + 1)
    assert nh.slab_calls(substeps, True) == [(0, total, None)]
    calls = nh.slab_calls(substeps, False)
    covered = [u for b, e, _ in calls for u in range(b, e)]
    assert covered == list(range(total))
    for _, end, _ in calls[:-1]:
        assert (end - 1) % (nh.COLORS + 1) % 4 == 0
    mesh = tt.grid_mesh(*BOX)
    arr = nhg.build_nh_grid_arrays(mesh, BOX, device="cpu")
    flips, last = [], None
    for _, p, _, _ in nhg._color_plan(arr):
        if last is not None and p[0] != last:
            flips.append("left" if p[0] == 1 else "right")
        last = p[0]
    assert len(flips) == 11
    assert [x for _, _, x in calls] == (flips + ["right"]) * substeps + [None]


def test_slab_moves_between_devices_only():
    """Over several devices K3s refreshes only the planes shared across a
    device boundary (``SlabMesh.device_cuts``): ``send_left`` /
    ``send_right`` with ``pairs`` move those pairs and leave the others."""
    mesh = SlabMesh(devices=["cpu"] * 4)
    assert mesh.device_cuts() == []
    spread = SlabMesh(devices=["cpu"] * 4)
    spread.devices = tuple(torch.device(d) for d in ("cuda:0", "cuda:0",
                                                      "cuda:1", "cuda:2"))
    assert spread.device_cuts() == [2, 3]
    src = [torch.full((3,), float(i)) for i in range(4)]
    dst = [torch.full((3,), -1.0) for _ in range(4)]
    mesh.send_left(src, dst, pairs=[2])
    assert [float(x[0]) for x in dst] == [-1.0, 2.0, -1.0, -1.0]
    mesh.send_right(src, dst, pairs=[3])
    assert [float(x[0]) for x in dst] == [-1.0, 2.0, -1.0, 2.0]
    mesh.send_right(src, dst)
    assert [float(x[0]) for x in dst] == [-1.0, 0.0, 1.0, 2.0]
