"""How the grid kernel K3 and the exact-order kernel K7 lay a frame out on
the card, checked on the CPU.

K3 (``csrc/nh_stencil.cu``) runs a whole frame in one cooperative launch:
its blocks walk each colour phase's (body, virtual block of 256 tet lanes)
pairs grid-stride; between two colours an item waits only for the items
within ``nh_stencil.reach`` of it.  The tests hold the phase plan to the
mesh (every tet of every colour exactly once), hold the reach to a brute
force over the kernel's lane -> corner map, and show, in plain torch, that
neither the order in which a colour's tets are solved nor any order of the
items that those waits allow changes a bit of the plain sweep.

K7 (``csrc/gs_ordered.cu``) walks a sub-level of the dragon's ordered
schedule with warp 0, a lane per tet and no barrier inside it; the tests
hold its tables to that (at most 32 tets per sub-level, no particle twice
in one)."""
import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import gs_ordered as go
from tetsim_torch.kernels import nh_stencil as nh
from tetsim_torch.parallel import SlabMesh
from tetsim_torch.solvers import common, neohookean_grid

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
SMS = (132, 7)  # an H100's SMs and a stand-in small card


def _sorted_rows(a):
    a = np.sort(np.asarray(a, np.int64), axis=1)
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 3, 2), (12, 9, 7),
                                  (56, 56, 56)])
def test_phase_plan_covers_each_tet_once(dims):
    """Every block's colour-phase items, at B = 1 and 2 and grids of 1 and 2
    blocks per SM, in virtual blocks of 256 lanes (with the volume error)
    and of ``item_lanes`` (without), cover each (body, virtual block) once;
    the virtual blocks' lanes give each colour's tets of the mesh exactly
    once."""
    widths = {nh.THREADS}
    for b in (1, 2):
        for sms in SMS:
            for per_sm in (1, 2):
                grid = per_sm * sms
                assert nh.item_lanes(dims, b, grid, True) == nh.THREADS
                for lanes in (nh.THREADS,
                              nh.item_lanes(dims, b, grid, False)):
                    widths.add(lanes)
                    nblk = nh.partial_blocks(dims, lanes)
                    items = nh.phase_items(b, dims, grid, lanes)
                    assert len(items) == grid
                    got = sorted(x for block in items for x in block)
                    assert got == [(k, v) for k in range(b)
                                   for v in range(nblk)]
    mesh = tt.grid_mesh(*dims)
    arr = neohookean_grid.build_nh_grid_arrays(mesh, dims, device="cpu")
    colors = neohookean_grid.grid_coloring(dims)
    most = ((dims[0] + 1) // 2) * ((dims[1] + 1) // 2) * ((dims[2] + 1) // 2)
    for lanes in sorted(widths):
        assert 32 <= lanes <= nh.THREADS
        nblk = nh.partial_blocks(dims, lanes)
        # the largest colour needs every virtual block
        assert (nblk - 1) * lanes < most <= nblk * lanes
    lanes = np.arange(nh.partial_blocks(dims) * nh.THREADS)
    for color in range(nh.COLORS):
        corners = nh.color_corners(dims, arr.corner_slab, color, lanes)
        live = corners[:, 0] >= 0
        np.testing.assert_array_equal(
            _sorted_rows(corners[live]),
            _sorted_rows(mesh.tets[colors == color]), err_msg=f"{color}")


def _permuted_frame(pos, vel, arr, params, gid, gpos, rng):
    """The plain sweep's frame on flat planes, each colour's tets solved in
    a random order, a few at a time (as blocks may take them), with the
    plain engine's arithmetic: pos/vel [B, 3, N].  Returns (pos, prev,
    vel)."""
    dt = params.dt
    X, Y, Z = pos.unbind(1)
    VX, VY, VZ = vel.unbind(1)
    pid = torch.arange(arr.num_particles)
    for _ in range(params.num_substeps):
        PX, PY, PZ = X, Y, Z
        X, Y, Z, VX, VY, VZ = neohookean_grid.predict_phase(
            arr.inv_mass, X, Y, Z, VX, VY, VZ, params, dt)
        X, Y, Z = X.clone(), Y.clone(), Z.clone()
        for color in range(nh.COLORS):
            t = color >> 3
            lanes = rng.permutation(nh.partial_blocks(arr.dims) * nh.THREADS)
            corners = nh.color_corners(arr.dims, arr.corner_slab, color, lanes)
            corners = corners[corners[:, 0] >= 0]
            for chunk in np.array_split(corners, 3):
                if not len(chunk):
                    continue
                ids = torch.as_tensor(chunk.T)  # [4, k]
                pc = [[comp[:, i] for comp in (X, Y, Z)] for i in ids]
                imc = [arr.inv_mass[i] for i in ids]
                newp, _ = neohookean_grid._solve_color(
                    pc, imc, arr.inv_rest_pose[t], arr.inv_rest_volume, dt,
                    params.dev_compliance, params.vol_compliance)
                for k, i in enumerate(ids):
                    for c, comp in enumerate((X, Y, Z)):
                        comp[:, i] += newp[k][c] - pc[k][c]
        X, Y, Z, VX, VY, VZ = neohookean_grid.collide_grab_phase(
            X, Y, Z, PX, PY, PZ, pid, params, dt, gid, gpos)
    stack = lambda *a: torch.stack(a, dim=1)  # noqa: E731
    return stack(X, Y, Z), stack(PX, PY, PZ), stack(VX, VY, VZ)


def test_colour_order_changes_no_bit():
    """The plain sweep with each colour's tets permuted and taken a few at
    a time is bitwise ``grid_frame_reference`` on a 3x3x3 box with 2 bodies,
    a pin and a grab: the property K3's grid-stride colour phases rely
    on."""
    dims = (3, 3, 3)
    mesh = tt.grid_mesh(*dims, **SMALL)
    arr = neohookean_grid.build_nh_grid_arrays(mesh, dims, pinned=[0],
                                               device="cpu")
    params = tt.PhysicsParams(num_substeps=5)
    rng = np.random.RandomState(0)
    pos = torch.tensor(mesh.verts).T.contiguous()[None].repeat(2, 1, 1)
    vel = torch.tensor(rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32))
    gid = torch.tensor([[9], [-1]], dtype=torch.int32)
    gpos = pos[:, :, 9][:, None] + torch.tensor([0.0, 0.05, 0.02])
    want = nh.grid_frame_reference(pos, vel, arr, params, gid, gpos)
    got = _permuted_frame(pos, vel, arr, params, gid, gpos, rng)
    for name, g, w in zip(("pos", "prev", "vel"), got, want):
        assert torch.equal(g, w), name
    assert not torch.equal(want[0], pos)


def _brute_reach(dims, corner_slab, lanes):
    """The largest distance in virtual blocks of ``lanes`` lanes between two
    tets of different colours whose cubes share a vertex, from the kernel's
    lane -> corners map alone (``color_corners``, the cube of a tet being its
    smallest corner id)."""
    grid = tuple(n + 1 for n in dims)
    block = np.full(tuple(dims) + (6,), -1)  # per cube and Kuhn type
    lanes_all = np.arange(int(np.prod([(n + 1) // 2 for n in dims])))
    for color in range(nh.COLORS):
        corners = nh.color_corners(dims, corner_slab, color, lanes_all)
        live = corners[:, 0] >= 0
        cube = np.unravel_index(corners[live].min(axis=1), grid)
        assert (block[cube + (color >> 3,)] == -1).all()
        block[cube + (color >> 3,)] = lanes_all[live] // lanes
    assert (block >= 0).all()  # each cube's 6 tets, once each
    out = 0
    for d in np.ndindex(3, 3, 3):
        d = np.subtract(d, 1)
        a = block[tuple(slice(max(-x, 0), n - max(x, 0))
                        for x, n in zip(d, dims))]
        b = block[tuple(slice(max(x, 0), n - max(-x, 0))
                        for x, n in zip(d, dims))]
        gap = np.abs(a[..., :, None] - b[..., None, :])  # [..., 6, 6]
        if not d.any():  # the same cube: tets of different types only
            gap = gap[..., ~np.eye(6, dtype=bool)]
        if gap.size:
            out = max(out, int(gap.max()))
    return out


@pytest.mark.parametrize("dims", [(2, 2, 2), (3, 4, 5), (5, 5, 5), (6, 3, 7),
                                  (8, 8, 8), (9, 7, 5), (16, 4, 4),
                                  (20, 20, 20)])
def test_reach_is_the_widest_neighbour_distance(dims):
    """``nh_stencil.reach``: every two tets of different colours whose cubes
    share a vertex lie within it (in virtual blocks of 1, 3, 8 and 256
    lanes, the kernel's), and some two lie at exactly it, so the neighbour
    window is wide enough and no wider."""
    arr = neohookean_grid.build_nh_grid_arrays(tt.grid_mesh(*dims), dims,
                                               device="cpu")
    for lanes in (1, 3, 8, nh.THREADS):
        assert nh.reach(dims, lanes) == _brute_reach(
            dims, arr.corner_slab, lanes), lanes


def test_reach_of_the_scale_box():
    """The 56^3 box: 86 virtual blocks of 256 lanes a colour, and a
    neighbour cube at most 28 * 28 + 28 + 1 = 813 lanes away in every
    colour, so 4 blocks; without the volume error, on an H100's 132 blocks,
    132 items of 167 lanes, 5 apart."""
    dims = (56, 56, 56)
    assert nh.partial_blocks(dims) == 86
    assert nh.reach(dims) == -(-(28 * 28 + 28 + 1) // nh.THREADS) == 4
    assert nh.item_lanes(dims, 1, 132, False) == 167
    assert nh.partial_blocks(dims, 167) == 132
    assert nh.reach(dims, 167) == 5


def _flag_order_frame(pos, vel, arr, params, gid, gpos, rng, lanes):
    """The plain sweep's frame with each colour phase cut into items of
    ``lanes`` tet lanes that run in a random order the kernel's neighbour
    waits allow: item vb takes colour c once items vb - reach .. vb + reach
    have finished colour c - 1, however far the other items are."""
    dt = params.dt
    X, Y, Z = pos.unbind(1)
    VX, VY, VZ = vel.unbind(1)
    pid = torch.arange(arr.num_particles)
    most = int(np.prod([(n + 1) // 2 for n in arr.dims]))
    nblk, r = -(-most // lanes), nh.reach(arr.dims, lanes)
    assert nblk > 2 * r + 1  # some items run ahead of others
    for _ in range(params.num_substeps):
        PX, PY, PZ = X, Y, Z
        X, Y, Z, VX, VY, VZ = neohookean_grid.predict_phase(
            arr.inv_mass, X, Y, Z, VX, VY, VZ, params, dt)
        X, Y, Z = X.clone(), Y.clone(), Z.clone()
        done = np.full(nblk, -1)  # the last colour each item finished
        spread = 0
        while (done < nh.COLORS - 1).any():
            ready = [vb for vb in range(nblk) if done[vb] < nh.COLORS - 1
                     and done[max(vb - r, 0):vb + r + 1].min() >= done[vb]]
            vb = ready[rng.randint(len(ready))]
            color = done[vb] + 1
            t = color >> 3
            corners = nh.color_corners(
                arr.dims, arr.corner_slab, color,
                np.arange(vb * lanes, (vb + 1) * lanes))
            corners = corners[corners[:, 0] >= 0]
            if len(corners):
                ids = torch.as_tensor(corners.T)  # [4, k]
                pc = [[comp[:, i] for comp in (X, Y, Z)] for i in ids]
                imc = [arr.inv_mass[i] for i in ids]
                newp, _ = neohookean_grid._solve_color(
                    pc, imc, arr.inv_rest_pose[t], arr.inv_rest_volume, dt,
                    params.dev_compliance, params.vol_compliance)
                for k, i in enumerate(ids):
                    for c, comp in enumerate((X, Y, Z)):
                        comp[:, i] += newp[k][c] - pc[k][c]
            done[vb] = color
            spread = max(spread, done.max() - done.min())
        assert spread > 1  # far items were a colour apart and more
        X, Y, Z, VX, VY, VZ = neohookean_grid.collide_grab_phase(
            X, Y, Z, PX, PY, PZ, pid, params, dt, gid, gpos)
    stack = lambda *a: torch.stack(a, dim=1)  # noqa: E731
    return stack(X, Y, Z), stack(PX, PY, PZ), stack(VX, VY, VZ)


def test_neighbour_waits_change_no_bit():
    """Items of 4 tet lanes on a 16x4x4 box (8 a colour, reach 1) run in a
    random order that the neighbour waits allow, so that far items are
    colours apart: bitwise ``grid_frame_reference`` with 2 bodies, a pin
    and a grab."""
    dims = (16, 4, 4)
    mesh = tt.grid_mesh(*dims, **SMALL)
    arr = neohookean_grid.build_nh_grid_arrays(mesh, dims, pinned=[0],
                                               device="cpu")
    params = tt.PhysicsParams(num_substeps=1)
    rng = np.random.RandomState(1)
    pos = torch.tensor(mesh.verts).T.contiguous()[None].repeat(2, 1, 1)
    vel = torch.tensor(rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32))
    gid = torch.tensor([[9], [-1]], dtype=torch.int32)
    gpos = pos[:, :, 9][:, None] + torch.tensor([0.0, 0.05, 0.02])
    want = nh.grid_frame_reference(pos, vel, arr, params, gid, gpos)
    got = _flag_order_frame(pos, vel, arr, params, gid, gpos, rng, 4)
    for name, g, w in zip(("pos", "prev", "vel"), got, want):
        assert torch.equal(g, w), name
    assert not torch.equal(want[0], pos)


def test_launch_counts():
    """K3 is one launch per frame, and so is K3s on each device where the
    mesh's slabs lie on one device; the plain paths count none."""
    assert nh.LAUNCHES_PER_FRAME == 1
    assert nh.SLAB_LAUNCHES_PER_FRAME == 1
    assert len(nh.slab_calls(5, True)) == nh.SLAB_LAUNCHES_PER_FRAME
    dims = (2, 2, 2)
    mesh = tt.grid_mesh(*dims, **SMALL)
    arr = neohookean_grid.build_nh_grid_arrays(mesh, dims, device="cpu")
    gid, gpos = common.norm_grabs(tt.Controls.none("cpu"))
    pos = torch.tensor(mesh.verts).T.contiguous()[None]
    before = nh.launch_count
    nh.grid_frame(pos, torch.zeros_like(pos), arr, tt.PhysicsParams(),
                  gid[None], gpos[None])
    assert nh.launch_count == before
    dims = (4, 2, 2)
    mesh = tt.grid_mesh(*dims, **SMALL)
    arr = neohookean_grid.build_nh_grid_arrays(mesh, dims, device="cpu")
    slabs = SlabMesh(devices=["cpu"] * 2)
    prepare, step, _ = nh.make_nh_sharded_stepper(slabs, arr)
    before = nh.segment_launch_count
    step(prepare(tt.init_state(mesh, "cpu"), tt.PhysicsParams()),
         tt.PhysicsParams(), tt.Controls.none("cpu"))
    assert nh.segment_launch_count == before


@pytest.fixture(scope="module")
def dragon_tables():
    return go.ordered_tables(go.build_ordered_schedule(tt.load_dragon()),
                             "cpu")


def test_dragon_sub_levels(dragon_tables):
    """The dragon's sub-levels as K7 walks them: 703 of them over 3,840
    tets, each of at most 32 tets (a lane each) in its first columns, and
    none touching a particle twice, so its lanes need no barrier between
    them."""
    ids = dragon_tables.sub_ids.numpy()
    assert ids.shape == (703, 4, 32)
    live = ids[:, 0] >= 0
    count = live.sum(axis=1)
    assert count.sum() == 3840 and count.min() >= 1
    for l, w in enumerate(count):
        assert live[l, :w].all(), l
        corners = ids[l, :, :w].reshape(-1)
        assert (corners >= 0).all() and len(set(corners)) == 4 * w, l
        assert (ids[l, :, w:] == -1).all(), l
