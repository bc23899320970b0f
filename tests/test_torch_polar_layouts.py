"""How the two polar tet-pass kernels K4 and K6 hold their deltas between
the tet pass and the particle sums, checked on the CPU.

K4 (``csrc/polar_stencil.cu``): a block of pass A solves the 6 tets of each
of ``STRIP`` consecutive cubes, and sums each cube's corner deltas per slab
in shared memory, over the types in order, into 24 floats per cube (a
scratch [B, 24, C]); pass B adds a vertex's 8 slab sums in slab order.  The
tests hold the block plan to the box (every tet once, a cube's 6 tets in
one block) and run frames whose solve goes through that layout in plain
torch (``slab_sums_reference``, ``gather24_reference``), bit for bit the
plain frame.

K6 (``csrc/polar_pieces.cu``): one block holds a whole piece, its planes
and its deltas in shared memory at slot k*rt + t, so a piece must fit a
block; a plain emulation that walks piece by piece with the deltas held
per piece gives the plain solve's bits."""
import dataclasses

import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import polar_pieces as pp
from tetsim_torch.kernels import polar_stencil as ps
from tetsim_torch.kernels.batch import SMEM_LIMIT
from tetsim_torch.solvers import polar_grid

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SM_SHARED = 233_472  # shared memory of one Hopper SM (228 KB)
SM_RESERVED = 1_024  # reserved per resident block


def _kernel_order_solve(calls):
    """``polar_grid._solve`` with K4's layout between its passes: the plain
    tet pass, its deltas in the kernel's [B, 6, 4, 3, C], the slab sums and
    the inverse stencil by the kernel's index arithmetic."""
    def solve(fx, fy, fz, quats, g, iters=polar_grid.EXTRACT_ITERS,
              halo=None):
        assert halo is None
        calls.append(1)
        deltas, new_quats = polar_grid.tet_deltas(fx, fy, fz, quats, g, iters)
        nx, ny, nz = g.dims
        b = fx.shape[0]
        d = torch.stack([torch.stack([torch.stack(deltas[t][k], 1)
                                      for k in range(4)], 1)
                         for t in range(6)], 1)  # [B, 6, 4, 3, Lc]
        d = d.reshape(b, 6, 4, 3, nx, ny + 1, nz + 1)[..., :ny, :nz]
        sums = ps.slab_sums_reference(d.reshape(b, 6, 4, 3, -1),
                                      g.corner_slab)
        num = ps.gather24_reference(sums, g.dims)
        pad = num.new_zeros((b, 3, (ny + 1) * (nz + 1)))  # the phantom plane
        num = torch.cat([num, pad], dim=-1)
        return (*polar_grid.apply_numerators(fx, fy, fz, num[:, 0],
                                             num[:, 1], num[:, 2], g),
                new_quats)
    return solve


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 3, 2)])
def test_slab_sum_layout_is_the_plain_frame(dims, b, monkeypatch):
    """One frame (5 substeps) with K4's slab-sum layout between the passes
    is bit for bit the plain frame: seeded velocities and quaternions, a
    pinned vertex and a grab on each box."""
    mesh = tt.grid_mesh(*dims, cell=0.1, origin=(-0.15, 0.3, -0.1))
    arr = polar_grid.build_grid_arrays(mesh, dims, pinned=[0], device="cpu")
    params = tt.PhysicsParams(num_substeps=5)
    n, c = arr.num_particles, arr.num_tets // 6
    rng = np.random.RandomState(7)
    pos = torch.tensor(np.broadcast_to(mesh.verts.T, (b, 3, n)).copy())
    vel = torch.tensor(rng.uniform(-0.5, 0.5, (b, 3, n)).astype(np.float32))
    q = rng.normal(size=(b, 6, 4, c)).astype(np.float32)
    quats = torch.tensor(q / np.linalg.norm(q, axis=2, keepdims=True))
    gid = torch.tensor([[n - 1 - k] for k in range(b)], dtype=torch.int32)
    gpos = torch.tensor(mesh.verts[gid.numpy()[:, 0]][:, None]
                        + np.float32([0.0, 0.05, 0.02]))
    want = ps.grid_frame_reference(pos, vel, quats, arr, params, gid, gpos)
    calls = []
    monkeypatch.setattr(polar_grid, "_solve", _kernel_order_solve(calls))
    got = ps.grid_frame_reference(pos, vel, quats, arr, params, gid, gpos)
    assert len(calls) == params.num_substeps
    for what, x, y in zip(("pos", "prev", "vel", "quats"), got, want):
        assert torch.equal(x, y), what
    assert not torch.equal(want[0], pos)  # the frame moved the box
    assert torch.equal(want[0][:, :, 0], pos[:, :, 0])  # pinned
    for k in range(b):
        assert torch.equal(want[0][k, :, n - 1 - k], gpos[k, 0])  # grabbed


@pytest.mark.parametrize("strip", [32, 64])
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 3, 3), (5, 4, 7),
                                  (56, 56, 56)])
def test_block_plan_covers_each_tet_once(dims, strip):
    """Pass A's (strip, w, t) threads give every tet t*C + cube of the box
    exactly once, and a cube's 6 tets to one block (its slab sums are
    formed there); the scratch between the passes is 24 C floats a body."""
    c = dims[0] * dims[1] * dims[2]
    cube, t = ps.block_plan(dims, strip)
    blocks = -(-c // strip)
    assert cube.shape == t.shape == (blocks, 6 * strip)
    live = cube >= 0
    assert live.sum() == 6 * c
    tets = np.sort((t * c + cube)[live])
    np.testing.assert_array_equal(tets, np.arange(6 * c))
    block = np.broadcast_to(np.arange(blocks)[:, None], cube.shape)
    np.testing.assert_array_equal(block[live], cube[live] // strip)
    # a warp (32 threads) is one type over consecutive cubes
    warps = t.reshape(blocks, -1, 32)
    first = warps[..., :1]
    assert ((warps == first) | (warps < 0)).all()
    assert ps.scratch(2, c, "cpu").shape == (2, 24, c)
    if dims == (56, 56, 56):  # 16.9 MB at 56^3, a third of the first 72 rows
        assert 24 * 4 * c == 16_859_136


@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 3, 3), (4, 3, 2)])
def test_slab_items_are_the_reference_terms(dims):
    """The table pass A sums from: slab s lists each corner 4t + c of the
    box's types that lies in it once, by type in order, as
    ``slab_sums_reference`` adds them; the 24 corners fill the 8 slabs."""
    mesh = tt.grid_mesh(*dims)
    arr = polar_grid.build_grid_arrays(mesh, dims, device="cpu")
    items = ps.slab_items(arr.corner_slab)
    assert items.shape == (8, 6) and items.dtype == np.int32
    for s in range(8):
        want = [4 * t + c for t in range(6) for c in range(4)
                if arr.corner_slab[t][c] == s]
        got = items[s]
        assert got[:len(want)].tolist() == want
        assert (got[len(want):] == -1).all()
        assert len({i // 4 for i in want}) == len(want)  # one per type
    assert sorted(items[items >= 0].tolist()) == list(range(24))


def test_pieces_sizing():
    """K6 holds a piece in one block: at bench.py's 2,048 tets per piece
    (rp 1,152, rt 2,048) two blocks fit an SM; a piece over a block's shared
    memory is refused by name, with no card; one launch per substep."""
    need = pp.smem_bytes(1152, 2048)
    assert need == 112_128
    assert 2 * need <= SMEM_LIMIT
    assert 2 * (need + SM_RESERVED) <= SM_SHARED
    assert pp.LAUNCHES_PER_SUBSTEP == 1
    blob = tt.ellipsoid_mesh(n=8, radii=(0.4, 0.3, 0.35),
                             center=(0.0, 0.8, 0.0))
    arr = pp.build_pieces_arrays(blob, tets_per_piece=128, device="cpu")
    pp.check_fits(arr)
    fits = dataclasses.replace(arr, rp=1152, rt=2048)
    pp.check_fits(fits)
    big = dataclasses.replace(arr, rp=2560, rt=4608)
    assert pp.smem_bytes(big.rp, big.rt) > SMEM_LIMIT
    with pytest.raises(ValueError, match=f"SMEM_LIMIT = {SMEM_LIMIT}") as e:
        pp.check_fits(big)
    largest = int(str(e.value).rsplit(" ", 1)[-1])
    assert largest % 128 == 0
    ratio = big.rp / big.rt
    assert pp.smem_bytes(int(largest * ratio), largest) <= SMEM_LIMIT
    assert pp.smem_bytes(int((largest + 128) * ratio), largest + 128) \
        > SMEM_LIMIT


def _fused_emulation(px, py, pz, quats, arr, iters):
    """K6's one-kernel solve in plain torch: piece by piece, the tet pass on
    the piece's lanes with its deltas held for the piece alone at slot
    k*rt + t, then each particle lane's banks in order from 0."""
    num = [torch.zeros_like(px) for _ in range(3)]
    q_out = torch.empty_like(quats)
    for b in range(arr.B):
        one = dataclasses.replace(arr, B=1, ids=arr.ids[:, b:b + 1],
                                  rc=arr.rc[:, b:b + 1],
                                  wvol=arr.wvol[b:b + 1])
        deltas, q = pp.tet_pass_reference(px[b:b + 1], py[b:b + 1],
                                          pz[b:b + 1], quats[:, b:b + 1],
                                          one, iters)
        held = torch.cat(deltas)  # [3, 4 rt]: this piece's shared memory
        q_out[:, b] = q[:, 0]
        for bank in arr.inc[:, b].unbind(0):
            live = bank >= 0
            for r in range(3):
                num[r][b] = torch.where(
                    live, num[r][b] + held[r, bank.clamp(min=0).long()],
                    num[r][b])
    return num[0], num[1], num[2], q_out


@pytest.mark.parametrize("banded", [False, True])
def test_piece_by_piece_order_is_the_plain_solve(banded):
    """The emulation of K6's one-block-per-piece walk is bit for bit the
    plain solve on the 960-tet blob at 128 tets per piece, on predicted
    planes with seeded velocities and seeded quaternions."""
    blob = tt.ellipsoid_mesh(n=8, radii=(0.4, 0.3, 0.35),
                             center=(0.0, 0.8, 0.0))
    arr = pp.build_pieces_arrays(blob, tets_per_piece=128,
                                 boundary_prefix=banded, device="cpu")
    assert arr.B > 1
    rng = np.random.RandomState(3)
    state = tt.init_state(blob, "cpu")
    vel = torch.tensor(rng.uniform(-1.0, 1.0, (blob.num_particles, 3))
                       .astype(np.float32))
    q = rng.normal(size=(blob.num_tets, 4)).astype(np.float32)
    state = state.replace(
        vel=vel, quats=torch.tensor(q / np.linalg.norm(q, axis=1,
                                                       keepdims=True)))
    params = tt.PhysicsParams(num_substeps=5)
    pack = pp.make_pieces_stepper(arr)[0]
    packed = pack(state, params)
    planes = pp.predict_planes(*packed[:6], arr.movw_l > 0.0, params.dt,
                               params)[:3]
    want = pp.pieces_solve_reference(*planes, packed[6], arr)
    got = _fused_emulation(*planes, packed[6], arr, params.extract_iters)
    for what, x, y in zip(("numx", "numy", "numz", "quats"), got, want):
        assert torch.equal(x, y), what
    assert want[0].abs().max() > 0
