"""The dense engine's frame kernel (``kernels/dense_frame.py``,
``csrc/dense_frame.cu``) on the CPU: ``DenseArrays.ids`` against the
one-hot and the JAX package's schedule, the gather and scatter by index
bitwise the one-hot products, a plain frame in the kernel's dataflow
(index gather and scatter, NaN and inf spread as the products spread them)
bitwise the twin, the same in the global form's dataflow on a cluster of
1, 2 and 16 blocks, the launch plan (shared or global form, the cluster
per body) and the shared form's refusal, the one-hot built only when the
twin reads it, the frame's work counts and the CUDA entry's refusal of
CPU tensors."""
import functools

import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.kernels.schedule import build_vmem_schedule
from tetsim_torch.kernels import dense_frame
from tetsim_torch.kernels.batch import SMEM_LIMIT
from tetsim_torch.kernels.polar_fused import split
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
        delta = dense.dense_level_reference(
            g, arr.irp[l], arr.irv[l], arr.imc[l], params).view(4, C, 3, B)
        valid = arr.irv[l] != 0
        _index_scatter(pos, ids.view(4, C)[:, valid].reshape(-1),
                       delta[:, valid].reshape(-1, 3, B))
        pos[:, :, unfinite] = float("nan")
    return pos


def _cluster_scatter(pos, C, slots, rows, d, cs):
    """The global form's scatter of one level on a cluster of ``cs``
    blocks, on pos [N, 3, B] in place: ``slots`` [V] the level's valid
    slots of C, ``rows`` [4, V] their corners' particles, d [4, V, 3, B]
    their deltas.  Block r of the cluster adds the deltas of its slots
    (``polar_fused.split(C, cs)[r]``) at their rows, counting per
    coordinate its deltas that are not finite and naming the particle of
    one; the counts are summed over the blocks (the level's barrier); in a
    coordinate with any, each block makes its own particles (``split(N,
    cs)``) NaN but for the particle named where the sum is 1.  Returns the
    summed counts [3, B]."""
    n, _, B = pos.shape
    total = torch.zeros(3, B, dtype=torch.long)
    named = torch.full((3, B), -1, dtype=torch.long)
    for lo, hi in split(C, cs):
        mine = (slots >= lo) & (slots < hi)
        flat = rows[:, mine].reshape(-1)
        dm = d[:, mine].reshape(-1, 3, B)
        pos[flat] = pos[flat] + dm
        bad = ~torch.isfinite(dm)
        total += bad.sum(dim=0)
        for r, b in torch.nonzero(bad.any(dim=0)).tolist():
            named[r, b] = flat[torch.nonzero(bad[:, r, b])[-1, 0]]
    spread = torch.nonzero(total > 0).tolist()
    for lo, hi in split(n, cs) if spread else ():
        for r, b in spread:
            keep = pos[named[r, b], r, b].clone()
            pos[lo:hi, r, b] = float("nan")
            if total[r, b] == 1 and lo <= named[r, b] < hi:
                pos[named[r, b], r, b] = keep
    return total


def _cluster_project(pos, arr, params, cs):
    """``dense.project_constraints`` in the global form's dataflow on a
    cluster of ``cs`` blocks, each body on its own: a body is finite where
    every block's predictions (its particles of ``split(N, cs)``) are (the
    substep's first barrier); at each level a body not finite turns all
    NaN, else each block solves its valid slots of ``split(C, cs)`` and
    ``_cluster_scatter`` adds the deltas; a body with a delta that is not
    finite is no longer finite."""
    n, _, B = pos.shape
    C = arr.slots_per_level
    finite = torch.ones(B, dtype=torch.bool)
    for lo, hi in split(n, cs):
        finite &= torch.isfinite(pos[lo:hi]).flatten(0, 1).all(dim=0)
    for l in range(arr.num_levels):
        done = ~finite
        slots = torch.nonzero(arr.irv[l] != 0)[:, 0]
        rows = arr.ids[l].long().view(4, C)[:, slots]
        d = torch.empty(4, len(slots), 3, B)
        for lo, hi in split(C, cs):  # each block's valid slots solved
            mine = (slots >= lo) & (slots < hi)
            if mine.any():
                t = slots[mine]
                d[:, mine] = dense.dense_level_reference(
                    pos[rows[:, mine].reshape(-1)].reshape(-1, 3 * B),
                    arr.irp[l][:, t], arr.irv[l][t], arr.imc[l][:, t],
                    params).view(4, -1, 3, B)
        total = _cluster_scatter(pos, C, slots, rows, d, cs)
        finite &= ~(total > 0).any(dim=0)
        pos[:, :, done] = float("nan")
    return pos


def _same(a, b):
    """torch.equal with NaN equal to NaN (the NaN masks equal)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


FRAME_PARAMS = tt.PhysicsParams(num_substeps=2)
_twins: dict = {}  # repr(plant) -> the twin's three frames


def _frame_case(mesh, arr, plant):
    """The frame tests' start, B = 3 from a shared jittered start with
    seeded velocities, body 1 grabbed, ``plant`` (where not None) in the
    coordinates of particle 4 of body 0; and the twin's three frames of 2
    substeps from it, computed once a plant.  Returns (start, grab_id,
    grab_pos, twin frames)."""
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
    start = dense.DenseState(*(torch.as_tensor(x) for x in (pos, pos, vel)))
    if repr(plant) not in _twins:
        frames, twin = [], start
        for _ in range(3):
            twin = dense.frame_reference(twin, arr, FRAME_PARAMS, gid, gpos)
            frames.append(twin)
        _twins[repr(plant)] = frames
    return start, gid, gpos, _twins[repr(plant)]


def _hold_to_twin(project, plant, small, monkeypatch):
    """Three frames with the twin's sweep replaced by ``project``: the
    twin's bits after each frame, NaN masks included; with a plant, body
    0 all NaN and the other bodies finite."""
    mesh, arr = small
    model, gid, gpos, twins = _frame_case(mesh, arr, plant)
    for twin in twins:
        with monkeypatch.context() as m:
            m.setattr(dense, "project_constraints", project)
            model = dense.frame_reference(model, arr, FRAME_PARAMS, gid, gpos)
        for k in ("pos", "prev_pos", "vel"):
            assert _same(getattr(model, k), getattr(twin, k)), k
    nan = torch.isnan(twins[-1].pos)
    assert nan[:, :, 0].all() == (plant is not None)
    assert not nan[:, :, 1:].any()


@pytest.mark.parametrize("plant", [None, float("nan"), float("inf"), 1e30])
def test_index_frame_bitwise_twin(plant, small, monkeypatch):
    """Three frames of 2 substeps, B = 3 from a shared jittered start with
    seeded velocities, body 1 grabbed (``_frame_case``): the twin with its
    sweep in the kernel's dataflow (``_index_project``) gives the twin's
    bits, NaN mask included, after each frame; with a NaN, an inf or 1e30
    (whose tets' deltas overflow to NaN from a finite body) planted in the
    coordinates of one particle of body 0, body 0 turns NaN and the other
    bodies stay finite."""
    _hold_to_twin(_index_project, plant, small, monkeypatch)


@pytest.mark.parametrize("cs", [1, 2, 16])
@pytest.mark.parametrize("plant", [None, float("nan"), float("inf"), 1e30])
def test_cluster_frame_bitwise_twin(plant, cs, small, monkeypatch):
    """``test_index_frame_bitwise_twin``'s three frames with the twin's
    sweep in the cluster walk's dataflow on a cluster of cs blocks
    (``_cluster_project``: 27 particles and 128 slots a level in cs ranges,
    at cs = 16 some of them empty): the twin's bits, NaN masks included,
    after each frame, clean and with a NaN, an inf or 1e30 planted in
    body 0, which alone turns NaN."""
    _hold_to_twin(functools.partial(_cluster_project, cs=cs), plant, small,
                  monkeypatch)


@pytest.mark.parametrize("case", ["one inf", "one nan", "two in a column",
                                  "every column"])
def test_scatter_spread_equals_products(case, small):
    """A level's scatter with deltas that are not finite, in the kernel's
    rule (``_index_scatter``, and ``_cluster_scatter`` on clusters of 1, 2
    and 16 blocks), against ``addmm_`` on level 0 of grid_mesh(2, 2, 2), B
    = 2: an inf alone in its column keeps pos + inf
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
    for cs in (1, 2, 16):  # the global form's scatter on a cluster
        cluster = pos.clone()
        _cluster_scatter(cluster, C, valid, ids[:, valid], delta[:, valid], cs)
        assert _same(cluster, want), cs
    if case == "one inf":
        assert got[ids[2, t0], 1, 0] == float("inf")
        assert torch.isnan(got[:, 1, 0]).sum() == mesh.num_particles - 1


@pytest.mark.parametrize("n,form", [(1_234, "shared"), (19_370, "shared"),
                                    (19_371, "global"), (19_376, "global")])
def test_launch_plan_and_size_check(n, form):
    """THREADS threads a block, B = 1, 8, 66, 67 and 132: a body of up to
    19,370 particles runs on a block with its positions in shared memory
    (12 bytes a particle against a Hopper block's 232,448); a larger one on
    a cluster of blocks with its positions in a global scratch, no dynamic
    shared memory: three planes on one block (12 bytes a particle and
    body), a float4 a particle on more (16).  The cluster: the
    largest power of two up to 16 at which the batch's clusters run at once
    (``waves``: by default 132 // cs, one block per SM; with an H100's
    count of 7 clusters of 16, B = 8 takes 8), capped by the level's slots
    (``cluster_cap``: one pass of 256 a block; C = 4,864 and 2,432 16, 512
    2, 256 and 128 1).  Forced onto the shared form, a larger body is
    refused with both numbers named; any body may be forced onto the global
    form, and its cluster forced (``cs``), the shared form's not."""
    assert SMEM_LIMIT == 232_448
    assert [dense_frame.cluster_cap(c) for c in (4864, 2432, 512, 257, 256,
                                                 128, 1)] == [16, 16, 2, 2,
                                                              1, 1, 1]
    h100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
    want = {None: {1: 16, 8: 16, 66: 2, 67: 1, 132: 1},
            "h100": {1: 16, 8: 8, 66: 2, 67: 1, 132: 1}}
    for key, waves in ((None, None), ("h100", h100)):
        for B, cs in want[key].items():
            shared = ("shared", B, 256, 12 * n, 0, 1)
            glob = ("global", B * cs, 256, 0, (12 if cs == 1 else 16) * n * B,
                    cs)
            assert dense_frame.launch_plan(B, n, 4864, waves=waves) == (
                shared if form == "shared" else glob)
            assert dense_frame.launch_plan(B, n, 4864, "global", waves) == glob
            assert dense_frame.launch_plan(B, n, 2432, "global",
                                           waves).cluster == cs
            for c in (256, 128):  # the dragon's levels: a block per body
                assert dense_frame.launch_plan(B, n, c, "global", waves) == (
                    "global", B, 256, 0, 12 * n * B, 1)
            assert dense_frame.launch_plan(B, n, 256, "global", waves,
                                           cs=4) == (
                "global", 4 * B, 256, 0, 16 * n * B, 4)
            assert dense_frame.launch_plan(B, n, 512, "global",
                                           waves).cluster == min(cs, 2)
    if form == "shared":
        assert dense_frame.launch_plan(8, n, 256, "shared") == (
            "shared", 8, 256, 12 * n, 0, 1)
        dense_frame.check_fits(n)
    else:
        with pytest.raises(ValueError, match=f"{12 * n} bytes.*232448"):
            dense_frame.launch_plan(8, n, 256, "shared")
        with pytest.raises(ValueError, match=f"{12 * n} bytes.*232448"):
            dense_frame.check_fits(n)
    with pytest.raises(ValueError, match="unknown form"):
        dense_frame.launch_plan(8, n, 256, "registers")
    if form == "shared":
        with pytest.raises(ValueError, match="shared form runs a block"):
            dense_frame.launch_plan(8, n, 256, cs=2)


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
    assert dense_frame.launch_plan(8, arr.num_particles, 4_864).form == (
        "global")
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
    once, a grab per body, the tables' valid slots once (72 bytes a
    tet)."""
    mesh, arr = dragon_arrays
    params = tt.default_cpu_params()
    L, C = arr.irv.shape
    assert (mesh.num_tets, mesh.num_particles, L, C) == (3840, 1234, 32, 256)
    assert dense_frame.frame_flops(arr, params, 128) == (
        128 * 5 * (421 * 3840 + 13 * 1234))
    assert dense_frame.frame_bytes(arr, 128) == (
        128 * (5 * 12 * 1234 + 16) + 3840 * (4 * 4 + 9 * 4 + 4 + 4 * 4))


def test_frame_entry_refuses_cpu(small):
    """The CUDA entry raises on CPU tensors rather than run the twin."""
    mesh, arr = small
    n = mesh.num_particles
    with pytest.raises(ValueError, match="runs on CUDA"):
        dense_frame.dense_frame(torch.zeros(n, 3, 2), torch.zeros(n, 3, 2),
                                arr, tt.PhysicsParams(),
                                torch.full((2,), -1, dtype=torch.int32),
                                torch.zeros(3, 2))
