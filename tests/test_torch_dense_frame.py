"""The dense engine's frame kernel (``kernels/dense_frame.py``,
``csrc/dense_frame.cu``) on the CPU: ``DenseArrays.ids`` against the
one-hot and the JAX package's schedule, the gather and scatter by index
bitwise the one-hot products, a plain frame in the kernel's dataflow
(index gather and scatter, NaN and inf spread as the products spread them)
bitwise the twin, the launch plan (shared or global form) and the shared
form's refusal, the one-hot built only when the twin reads it, the frame's
work counts and the CUDA entry's refusal of CPU tensors."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels.schedule import build_vmem_schedule
from tetsim_torch.kernels import dense_frame, dense_level
from tetsim_torch.kernels.batch import SMEM_LIMIT
from tetsim_torch.mesh import single_tet_mesh
from tetsim_torch.solvers import dense

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.25, 0.1, -0.25))  # tests/test_dense.py's


@pytest.fixture(scope="module")
def small():
    mesh = tt.grid_mesh(2, 2, 2, **SMALL)
    return mesh, dense.build_dense_arrays(mesh, device="cpu")


@pytest.fixture(scope="module")
def dragon_arrays():
    mesh = tt.load_dragon()
    return mesh, dense.build_dense_arrays(mesh, device="cpu")


@pytest.mark.parametrize("coloring", ["greedy", "ordered"])
def test_ids_equal_jax_schedule(coloring):
    """``DenseArrays.ids`` is the JAX package's schedule's ``ids``, bit for
    bit, padded slots included."""
    jm = ts.grid_mesh(2, 2, 2, **SMALL)
    want = build_vmem_schedule(jm, 1000.0, coloring).ids
    arr = dense.build_dense_arrays(tt.grid_mesh(2, 2, 2, **SMALL),
                                   coloring=coloring, device="cpu")
    assert arr.ids.dtype == torch.int32
    np.testing.assert_array_equal(arr.ids.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["small", "dragon"])
def test_index_gather_scatter_equal_products(which, small, dragon_arrays):
    """On every level of grid_mesh(2, 2, 2) and the dragon's first 3 greedy
    levels, B = 4: the gather ``flat[ids]`` equals ``onehot[l].T @ flat`` on
    every valid slot (padded slots gather 0), and adding the deltas at
    ``ids`` equals ``addmm_(onehot[l], delta)``, with torch.equal."""
    mesh, arr = small if which == "small" else dragon_arrays
    rng = np.random.RandomState(5)
    B, C = 4, arr.slots_per_level
    pos = torch.as_tensor((mesh.verts[:, :, None] + rng.normal(
        0, 0.05, (mesh.num_particles, 3, B))).astype(np.float32))
    flat = pos.view(mesh.num_particles, 3 * B)
    for l in range(3 if which == "dragon" else arr.num_levels):
        valid = (arr.irv[l] != 0).repeat(4)
        g = arr.onehot[l].T @ flat
        assert torch.equal(flat[arr.ids[l].long()][valid], g[valid])
        assert not g[~valid].any()
        delta = torch.as_tensor(rng.normal(0, 0.01, g.shape).astype(np.float32))
        want = flat.clone().addmm_(arr.onehot[l], delta)
        got = flat.clone()
        rows = arr.ids[l].long()[valid]
        assert len(set(rows.tolist())) == len(rows)  # a particle once a level
        got[rows] = got[rows] + delta[valid]
        assert torch.equal(got, want)


def _index_scatter(pos, rows, d):
    """The kernel's scatter on pos [N, 3, B] in place: d [V, 3, B] added at
    rows [V] (each particle once), then the products' spread: in a column
    (r, b) with a delta that is not finite, coordinate r of every particle
    is NaN, but for the particle of the column's only one, which keeps
    pos + delta."""
    new = pos[rows] + d
    pos[rows] = new
    bad = ~torch.isfinite(d)  # [V, 3, B]
    count = bad.sum(dim=0)  # [3, B]
    keep = pos[rows].clone()
    pos[:, count > 0] = float("nan")
    only = count == 1
    r, b = torch.nonzero(only, as_tuple=True)
    for r_, b_ in zip(r.tolist(), b.tolist()):
        v = torch.nonzero(bad[:, r_, b_])[0, 0]
        pos[rows[v], r_, b_] = keep[v, r_, b_]
    return pos


def _index_project(pos, arr, params):
    """``dense.project_constraints`` in the kernel's dataflow, with its
    arithmetic from the twin's level solve: per body, a level that starts
    with a coordinate that is not finite ends with every coordinate NaN;
    else the valid slots' corners are gathered by index, solved, and their
    deltas added by index (``_index_scatter``)."""
    n, _, B = pos.shape
    C = arr.slots_per_level
    for l in range(arr.num_levels):
        unfinite = ~torch.isfinite(pos).all(dim=0).all(dim=0)  # [B]
        ids = arr.ids[l].long()
        g = pos[ids].reshape(4 * C, 3 * B)
        delta = dense_level.dense_level_reference(
            g, arr.irp[l], arr.irv[l], arr.imc[l], params).view(4, C, 3, B)
        valid = arr.irv[l] != 0
        _index_scatter(pos, ids.view(4, C)[:, valid].reshape(-1),
                       delta[:, valid].reshape(-1, 3, B))
        pos[:, :, unfinite] = float("nan")
    return pos


def _same(a, b):
    """torch.equal with NaN equal to NaN (the NaN masks equal)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("plant", [None, float("nan"), float("inf"), 1e30])
def test_index_frame_bitwise_twin(plant, small, monkeypatch):
    """Three frames of 2 substeps, B = 3 from a shared jittered start with
    seeded velocities, body 1 grabbed: the twin with its sweep in the
    kernel's dataflow (``_index_project``) gives the twin's bits, NaN mask
    included, after each frame; with a NaN, an inf or 1e30 (whose tets'
    deltas overflow to NaN from a finite body) planted in the coordinates
    of one particle of body 0, body 0 turns NaN and the other bodies stay
    finite."""
    mesh, arr = small
    rng = np.random.RandomState(11)
    B = 3
    pos = (mesh.verts[:, :, None] + rng.uniform(-0.05, 0.05, (1, 3, B))
           + [[[0.0], [0.3], [0.0]]]).astype(np.float32)
    vel = rng.normal(0, 0.3, pos.shape).astype(np.float32)
    if plant is not None:
        pos[4, :, 0] = plant
    gid = torch.tensor([-1, 5, -1], dtype=torch.int32)
    gpos = torch.zeros(3, B)
    gpos[1] = torch.tensor([0.2, 1.4, 0.0])
    params = tt.PhysicsParams(num_substeps=2)
    twin = model = dense.DenseState(*(torch.as_tensor(x)
                                      for x in (pos, pos, vel)))
    for _ in range(3):
        twin = dense.frame_reference(twin, arr, params, gid, gpos)
        with monkeypatch.context() as m:
            m.setattr(dense, "project_constraints", _index_project)
            model = dense.frame_reference(model, arr, params, gid, gpos)
        for k in ("pos", "prev_pos", "vel"):
            assert _same(getattr(model, k), getattr(twin, k)), k
    nan = torch.isnan(twin.pos)
    assert nan[:, :, 0].all() == (plant is not None)
    assert not nan[:, :, 1:].any()


@pytest.mark.parametrize("case", ["one inf", "one nan", "two in a column",
                                  "every column"])
def test_scatter_spread_equals_products(case, small):
    """A level's scatter with deltas that are not finite, in the kernel's
    rule (``_index_scatter``), against ``addmm_`` on level 0 of
    grid_mesh(2, 2, 2), B = 2: an inf alone in its column keeps pos + inf
    at its particle and NaN elsewhere in the column; two in a column, or a
    NaN, leave the column NaN; the other columns and body untouched."""
    mesh, arr = small
    rng = np.random.RandomState(2)
    B, C = 2, arr.slots_per_level
    pos = torch.as_tensor((mesh.verts[:, :, None] + rng.normal(
        0, 0.05, (mesh.num_particles, 3, B))).astype(np.float32))
    delta = torch.as_tensor(rng.normal(0, 0.01, (4, C, 3, B)).astype(np.float32))
    valid = torch.nonzero(arr.irv[0] != 0)[:, 0]
    t0, t1 = int(valid[0]), int(valid[-1])
    if case == "one inf":
        delta[2, t0, 1, 0] = float("inf")
    elif case == "one nan":
        delta[0, t1, 2, 1] = float("nan")
    elif case == "two in a column":
        delta[1, t0, 0, 1] = float("-inf")
        delta[3, t1, 0, 1] = float("inf")
    else:
        delta[:, t0] = float("inf")
    want = pos.clone()
    want.view(-1, 3 * B).addmm_(arr.onehot[0], delta.reshape(4 * C, 3 * B))
    ids = arr.ids[0].long().view(4, C)
    got = _index_scatter(pos.clone(), ids[:, valid].reshape(-1),
                         delta[:, valid].reshape(-1, 3, B))
    assert _same(got, want)
    if case == "one inf":
        assert got[ids[2, t0], 1, 0] == float("inf")
        assert torch.isnan(got[:, 1, 0]).sum() == mesh.num_particles - 1


@pytest.mark.parametrize("n,form", [(1_234, "shared"), (19_370, "shared"),
                                    (19_371, "global"), (19_376, "global")])
def test_launch_plan_and_size_check(n, form):
    """A block per body, THREADS threads, B = 8: a body of up to 19,370
    particles keeps its positions in the block's shared memory (12 bytes a
    particle against a Hopper block's 232,448); a larger one in a global
    scratch of 12 bytes a particle and body, with no dynamic shared memory.
    Forced onto the shared form, a larger body is refused with both numbers
    named; any body may be forced onto the global form."""
    assert SMEM_LIMIT == 232_448
    B = 8
    shared = ("shared", B, 256, 12 * n, 0)
    glob = ("global", B, 256, 0, 12 * n * B)
    assert dense_frame.launch_plan(B, n) == (shared if form == "shared"
                                             else glob)
    assert dense_frame.launch_plan(B, n, "global") == glob
    if form == "shared":
        assert dense_frame.launch_plan(B, n, "shared") == shared
        dense_frame.check_fits(n)
    else:
        with pytest.raises(ValueError, match=f"{12 * n} bytes.*232448"):
            dense_frame.launch_plan(B, n, "shared")
        with pytest.raises(ValueError, match=f"{12 * n} bytes.*232448"):
            dense_frame.check_fits(n)
    with pytest.raises(ValueError, match="unknown form"):
        dense_frame.launch_plan(B, n, "registers")


def test_onehot_built_only_for_the_twin(small):
    """``build_dense_arrays`` allocates no one-hot: for
    replicate_mesh(single_tet_mesh(), 4843) (19,372 particles, L = 1, C =
    4,864, a 1.508 GB slab, the global form's) it builds the tables alone,
    and refuses the slab past ``max_bytes`` all the same; on grid_mesh(2,
    2, 2) the slab appears when the twin first steps, and the twin's frame
    from arrays whose slab was read first is the same bit for bit."""
    big = tt.replicate_mesh(single_tet_mesh(), 4843)
    arr = dense.build_dense_arrays(big, device="cpu")
    assert "onehot" not in vars(arr)
    assert (arr.num_particles, arr.num_levels, arr.slots_per_level) == (
        19_372, 1, 4_864)
    assert arr.ids.shape == (1, 4 * 4_864) and int((arr.irv != 0).sum()) == 4843
    assert dense_frame.launch_plan(8, arr.num_particles).form == "global"
    with pytest.raises(ValueError, match="1.5 GB"):
        dense.build_dense_arrays(big, max_bytes=1_500_000_000, device="cpu")

    mesh, built = small
    fresh = dense.build_dense_arrays(mesh, device="cpu")
    assert "onehot" not in vars(fresh) and fresh.num_levels == built.num_levels
    B = 2
    pos = torch.as_tensor(np.broadcast_to(
        mesh.verts[:, :, None], (mesh.num_particles, 3, B)).copy())
    start = dense.DenseState(pos, pos, torch.zeros_like(pos))
    gid, gpos = torch.full((B,), -1, dtype=torch.int32), torch.zeros(3, B)
    params = tt.PhysicsParams(num_substeps=1)
    got = dense.step_frame(start, fresh, params, gid, gpos)
    assert "onehot" in vars(fresh)
    assert torch.equal(fresh.onehot, built.onehot)
    want = dense.step_frame(start, built, params, gid, gpos)
    assert all(torch.equal(getattr(got, k), getattr(want, k))
               for k in ("pos", "prev_pos", "vel"))


def test_frame_work_from_shapes(dragon_arrays):
    """frame_flops: 421 a tet and 13 a particle, each substep and body;
    frame_bytes: the state read (pos, vel) and written (pos, prev, vel)
    once, a grab per body, the tables once (72 bytes a slot)."""
    mesh, arr = dragon_arrays
    params = tt.default_cpu_params()
    L, C = arr.irv.shape
    assert (mesh.num_tets, mesh.num_particles, L, C) == (3840, 1234, 32, 256)
    assert dense_frame.frame_flops(arr, params, 128) == (
        128 * 5 * (421 * 3840 + 13 * 1234))
    assert dense_frame.frame_bytes(arr, 128) == (
        128 * (5 * 12 * 1234 + 16) + 32 * 256 * (4 * 4 + 9 * 4 + 4 + 4 * 4))


def test_frame_entry_refuses_cpu(small):
    """The CUDA entry raises on CPU tensors rather than run the twin."""
    mesh, arr = small
    n = mesh.num_particles
    with pytest.raises(ValueError, match="runs on CUDA"):
        dense_frame.dense_frame(torch.zeros(n, 3, 2), torch.zeros(n, 3, 2),
                                arr, tt.PhysicsParams(),
                                torch.full((2,), -1, dtype=torch.int32),
                                torch.zeros(3, 2))
