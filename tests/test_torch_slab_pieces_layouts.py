"""How K4a and K5 lay a frame out, checked on the CPU in plain torch.

K4a (``csrc/polar_stencil.cu``, the polar slab form): two launches per
substep and device, pass A and a vertex pass B.  Pass B folds in what the first design did in three steps (the numerator planes,
``SlabMesh.add_halo``, the apply): a vertex on a shared plane adds the
gather of the neighbour slab's sums at its mirror vertex.  The tests run
frames whose solve goes through that order
(``polar_stencil.folded_gather_reference``) against the sharded twin with
its halo, bit for bit, at 1, 2 and 4 slabs; show that the ghost sums of a
neighbour on another device need only its boundary cube column; and hold
``polar_stencil.slab_calls``, the launches over several devices, to the
frame's phases and its launches.

K5 (``csrc/nh_pieces.cu``): one cooperative launch per frame, a piece phase
(predict, the sweep) and a lane phase (the completion across pieces,
collide, grab, velocity) per substep.  A plain model of the lane phase
that reads only the kernel's tables (``pidx``, ``is2``, ``lane_bnd``,
``bnd_inst``, ``bnd_count``, ``pid_l``), lane by lane in the kernel's order,
gives the bits of the first design's ``_complete_boundary``, collide, grab
and velocity, in both lane layouts, with a grab on a shared particle; and
frames built of the piece phase and that model give the plain frame's
bits."""
import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import nh_pieces as nhp
from tetsim_torch.kernels import polar_stencil as ps
from tetsim_torch.kernels.polar_pieces import predict_planes
from tetsim_torch.parallel import SlabMesh
from tetsim_torch.solvers import common, polar_grid

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

BOX = (8, 3, 2)  # cube columns divide into 1, 2 and 4 slabs


# -- K4a -------------------------------------------------------------------------


def _folded_solve(calls):
    """``polar_grid._solve`` on the stacked slabs [d, ...] in K4a's order:
    the plain tet pass, the slab sums [d, 24, C] and pass B's numerators by
    ``folded_gather_reference`` (own sums, plus the neighbour's at the
    mirror vertex of a shared plane); the halo hook is not called."""
    def solve(fx, fy, fz, quats, g, iters=polar_grid.EXTRACT_ITERS,
              halo=None):
        assert halo is not None  # the sharded twin's solve
        calls.append(1)
        deltas, new_quats = polar_grid.tet_deltas(fx, fy, fz, quats, g, iters)
        nx, ny, nz = g.dims
        b = fx.shape[0]
        d = torch.stack([torch.stack([torch.stack(deltas[t][k], 1)
                                      for k in range(4)], 1)
                         for t in range(6)], 1)  # [d, 6, 4, 3, Lc]
        d = d.reshape(b, 6, 4, 3, nx, ny + 1, nz + 1)[..., :ny, :nz]
        sums = ps.slab_sums_reference(d.reshape(b, 6, 4, 3, -1),
                                      g.corner_slab)
        num = ps.folded_gather_reference(sums, g.dims)
        pad = num.new_zeros((b, 3, (ny + 1) * (nz + 1)))  # the tail plane
        num = torch.cat([num, pad], dim=-1)
        return (*polar_grid.apply_numerators(fx, fy, fz, num[:, 0],
                                             num[:, 1], num[:, 2], g),
                new_quats)
    return solve


@pytest.mark.parametrize("d", [1, 2, 4])
def test_folded_pass_b_is_the_halo(d, monkeypatch):
    """On an 8x3x2 box in d slabs, seeded velocities and a grab on a vertex
    of a shared plane, 2 frames of 3 substeps whose numerators come from
    K4a's folded pass B are bit for bit ``make_grid_sharded_step`` with
    ``SlabMesh.add_halo`` (pass B1, the halo, pass B2), both replicas of
    every shared plane equal; without the mirror gathers they are not."""
    mesh = tt.grid_mesh(*BOX, cell=0.1, origin=(-0.4, 0.3, -0.1))
    garr = polar_grid.build_grid_arrays(mesh, BOX, pinned=[0], device="cpu")
    rng = np.random.RandomState(d)
    st = tt.init_state(mesh, "cpu")
    st = st.replace(vel=torch.tensor(rng.uniform(-0.5, 0.5, st.vel.shape)
                                     .astype(np.float32)))
    g = (BOX[1] + 1) * (BOX[2] + 1)
    vid = 4 * g + 5  # on plane x = 4, shared at 2 and 4 slabs
    target = torch.tensor(np.float32(mesh.verts[vid] + [0.0, 0.02, 0.01]))
    ctl = tt.Controls(grab_id=torch.tensor(vid, dtype=torch.int32),
                      grab_pos=target)
    params = tt.PhysicsParams(num_substeps=3)
    slabs = SlabMesh(devices=["cpu"] * d)
    twin = polar_grid.make_grid_sharded_step(slabs, garr)
    st0, sarr = polar_grid.grid_prepare(st, garr, slabs)
    want = got = st0
    calls = []
    lx = BOX[0] // d
    for _ in range(2):
        want, _ = twin(want, sarr, params, ctl)
        with monkeypatch.context() as m:
            m.setattr(polar_grid, "_solve", _folded_solve(calls))
            got, _ = twin(got, sarr, params, ctl)
        for f in ("pos", "prev", "vel", "quats"):
            assert all(torch.equal(x, y) for x, y in
                       zip(getattr(got, f), getattr(want, f))), f
        for i in range(1, d):
            assert torch.equal(got.pos[i - 1][:, lx * g:], got.pos[i][:, :g])
    assert len(calls) == 2 * params.num_substeps
    out = polar_grid.grid_unprepare(got, garr, d)
    assert torch.equal(out.pos[vid], target)
    assert not torch.equal(out.pos, st.pos)
    if d > 1:  # the mirror gathers carry the neighbour's half of the plane
        sums = torch.randn(d, 24, BOX[0] // d * BOX[1] * BOX[2])
        local = (lx,) + BOX[1:]
        own = ps.gather24_reference(sums, local)
        assert not torch.equal(ps.folded_gather_reference(sums, local), own)


@pytest.mark.parametrize("side", ["left", "right"])
def test_ghost_needs_the_boundary_column(side):
    """Across a device cut pass B reads the neighbour's sums from a ghost
    [24, C]: a ghost holding only the neighbour's boundary cube column (x =
    lx - 1 for the left neighbour, x = 0 for the right) gives the mirror
    gathers the full sums give."""
    local = (3, 4, 2)
    c = local[0] * local[1] * local[2]
    col = local[1] * local[2]
    sums = torch.randn(2, 24, c, generator=torch.Generator().manual_seed(3))
    full = ps.folded_gather_reference(sums, local)
    ghost = torch.zeros_like(sums)
    keep = slice((local[0] - 1) * col, c) if side == "left" else slice(0, col)
    peer = 0 if side == "left" else 1
    ghost[peer, :, keep] = sums[peer, :, keep]
    ghost[1 - peer] = sums[1 - peer]
    part = ps.folded_gather_reference(ghost, local)
    plane = (local[1] + 1) * (local[2] + 1)
    mine = slice(0, plane) if side == "left" else slice(local[0] * plane, None)
    assert torch.equal(part[1 - peer, :, mine], full[1 - peer, :, mine])


@pytest.mark.parametrize("substeps", [1, 5])
def test_k4a_slab_calls_cover_the_frame(substeps):
    """K4a's host calls per frame: one on a single device, which launches
    a kernel per phase (two per substep); over several devices, calls that
    cover the frame's 2 S phases once, each ending after a pass A (an odd
    phase count) and exchanging the sums' columns there, the last
    exchanging nothing."""
    total = 2 * substeps
    assert ps.slab_calls(substeps, True) == [(0, total, None)]
    assert total == ps.SLAB_LAUNCHES_PER_SUBSTEP * substeps
    calls = ps.slab_calls(substeps, False)
    assert [u for b, e, _ in calls for u in range(b, e)] == list(range(total))
    assert len(calls) == substeps + 1
    for _, end, exchange in calls[:-1]:
        assert end % 2 == 1 and exchange == "halo"
    assert calls[-1][1:] == (total, None)


# -- K5 --------------------------------------------------------------------------

BLOB = dict(n=8, radii=(0.4, 0.3, 0.35), center=(0.0, 0.8, 0.0))


@pytest.fixture(scope="module")
def blob():
    return tt.ellipsoid_mesh(**BLOB)


def _lane_phase(start, swept, pred, arr, params, gid, gpos):
    """K5's lane phase in plain torch, lane by lane as the kernel takes it,
    on the flat planes [3, B*rp] (the substep's start, the swept and the
    predicted positions), reading only the kernel's tables.  Returns the
    lanes' positions and velocities [3, B*rp] each."""
    rp, r2 = arr.rp, arr.r2
    lanes = torch.arange(arr.B * rp)
    b, i = lanes // rp, lanes % rp
    d = swept - pred
    p = swept.clone()
    band = (b * r2 + i).clamp(max=max(arr.B * r2 - 1, 0))
    pair = (i < r2) & (arr.is2.reshape(-1)[band] if r2 else False)
    q = arr.pidx.reshape(-1)[band[pair]].long()
    p[:, pair] = pred[:, pair] + ((swept[:, pair] - pred[:, pair])
                                  + d[:, q]) * 0.5
    rows = arr.lane_bnd.long()
    tier = (rows >= 0) & ~pair
    rows = rows[tier]
    count = arr.bnd_count[rows]
    n = count.long()
    tot = d[:, arr.bnd_inst[0, rows].long()]
    for j in range(1, int(n.max()) if len(n) else 0):
        more = n > j
        tot[:, more] = tot[:, more] + d[:, arr.bnd_inst[j, rows[more]].long()]
    p[:, tier] = pred[:, tier] + tot / count
    lo, hi = params.world_min, params.world_max
    x, y, z = (p[r].clamp(float(lo[r]), float(hi[r])) for r in range(3))
    below = y < 0.0
    y = torch.where(below, 0.0, y)
    k = np.minimum(np.float32(1.0), params.dt * params.friction)
    x = x + torch.where(below, (start[0] - x) * k, 0.0)
    z = z + torch.where(below, (start[2] - z) * k, 0.0)
    pid = arr.pid_l.reshape(-1)
    for g in range(gid.shape[0]):
        hit = pid == gid[g]
        x, y, z = (torch.where(hit, gpos[g, r], c)
                   for r, c in enumerate((x, y, z)))
    pos = torch.stack([x, y, z])
    dt = pos.new_full((), params.dt)
    return pos, (pos - start) / dt, pair, tier


def _kernel_order_substep(carry, arr, params, gid, gpos):
    """One substep as K5 runs it: the piece phase (predict, the plain
    sweep), then ``_lane_phase``."""
    movable = arr.movw_l > 0.0
    *pred, _, _, _ = predict_planes(*carry, movable, params.dt, params)
    swept = nhp.nh_pieces_solve_reference(*pred, arr, params)
    flat = [torch.stack([x.reshape(-1) for x in planes])
            for planes in (carry[:3], swept, pred)]
    pos, vel, _, _ = _lane_phase(*flat, arr, params, gid, gpos)
    shape = (arr.B, arr.rp)
    return tuple(x.reshape(shape) for x in (*pos, *vel))


def _shared_grab(blob, arr):
    """A grab on a particle with at least 3 instances (a boundary row),
    lifted 3 cm."""
    pid = arr.pid_l.reshape(-1)
    real = pid[pid < arr.num_particles]
    counts = torch.bincount(real.long(), minlength=arr.num_particles)
    vid = int(torch.nonzero(counts >= 3)[0])
    target = torch.tensor(np.float32(blob.verts[vid] + [0.0, 0.03, 0.0]))
    return vid, tt.Controls(grab_id=torch.tensor(vid, dtype=torch.int32),
                            grab_pos=target)


@pytest.mark.parametrize("banded", [False, True])
def test_lane_phase_is_the_torch_glue(blob, banded):
    """On the 960-tet blob at 128 tets per piece, both lane layouts, seeded
    velocities, a pinned particle and a grab on a shared particle: for 3
    substeps, the lane phase's model from the start, swept and predicted
    planes is bit for bit ``_complete_boundary``, collide, grab and
    velocity, and takes both the J=2 branch (banded) and the boundary
    rows; every instance of the grabbed particle ends at the target."""
    arr = nhp.build_nh_pieces_arrays(blob, tets_per_piece=128, pinned=[0],
                                     boundary_prefix=banded, device="cpu")
    vid, ctl = _shared_grab(blob, arr)
    gid, gpos = common.norm_grabs(ctl)
    params = tt.PhysicsParams(num_substeps=3)
    rng = np.random.RandomState(5)
    st = tt.init_state(blob, "cpu")
    st = st.replace(vel=torch.tensor(rng.uniform(-0.5, 0.5, st.vel.shape)
                                     .astype(np.float32)))
    carry = nhp.make_nh_pieces_stepper(arr)[0](st, params)
    movable = arr.movw_l > 0.0
    for _ in range(params.num_substeps):
        *pred, _, _, _ = predict_planes(*carry, movable, params.dt, params)
        swept = nhp.nh_pieces_solve_reference(*pred, arr, params)
        flat = [torch.stack([x.reshape(-1) for x in planes])
                for planes in (carry[:3], swept, pred)]
        pos, vel, pair, tier = _lane_phase(*flat, arr, params, gid, gpos)
        want = nhp._substep_local(carry, arr, params, params.dt, gid, gpos,
                                  nhp.nh_pieces_solve_reference)
        got = (*pos, *vel)
        for w, g in zip(want, got):
            assert torch.equal(w.reshape(-1), g)
        carry = want
    assert int(pair.sum()) > 0 if banded else int(pair.sum()) == 0
    assert int(tier.sum()) > 0
    hit = arr.pid_l.reshape(-1) == vid
    assert int(hit.sum()) >= 3
    assert torch.equal(pos[:, hit], gpos[0][:, None].expand(3, int(hit.sum())))


@pytest.mark.parametrize("banded", [False, True])
def test_kernel_order_frames_are_the_plain_frames(blob, banded):
    """2 frames of 3 substeps built of K5's piece phase and lane phase
    model are bit for bit ``nh_pieces_frame_reference``, the plain twin,
    with a grab on a shared particle."""
    arr = nhp.build_nh_pieces_arrays(blob, tets_per_piece=128,
                                     boundary_prefix=banded, device="cpu")
    _, ctl = _shared_grab(blob, arr)
    gid, gpos = common.norm_grabs(ctl)
    params = tt.PhysicsParams(num_substeps=3)
    want = got = nhp.make_nh_pieces_stepper(arr)[0](
        tt.init_state(blob, "cpu"), params)
    for _ in range(2):
        want = nhp.nh_pieces_frame_reference(want, arr, params, gid, gpos)
        for _ in range(params.num_substeps):
            got = _kernel_order_substep(got, arr, params, gid, gpos)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


def test_one_launch_per_frame():
    """The frame kernel counts one launch per frame; the frame's bytes
    grow with the completion's reads (a J=2 band and boundary rows cost
    more than the planes alone), and the kernel's own traffic adds the
    scratch's round trip and a second read of the start positions (15
    planes)."""
    assert nhp.LAUNCHES_PER_FRAME == 1
    blob = tt.ellipsoid_mesh(**BLOB)
    arr = nhp.build_nh_pieces_arrays(blob, tets_per_piece=128,
                                     boundary_prefix=True, device="cpu")
    one = tt.PhysicsParams(num_substeps=1)
    floor = (4 * 15 * arr.B * arr.rp + 4 * arr.l_max * arr.B
             + 72 * arr.num_tets)
    assert nhp.frame_bytes(arr, one) > floor + 5 * arr.B * arr.r2
    assert (nhp.frame_bytes(arr, tt.PhysicsParams(num_substeps=5))
            == 5 * nhp.frame_bytes(arr, one))
    assert nhp.design_bytes(arr, one) == 4 * 15 * arr.B * arr.rp
