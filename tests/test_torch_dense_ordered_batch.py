"""``World.add_body_batch(..., backend="dense_ordered")``: the dense
engine's batch on the order-preserving levels (``mesh.level_schedule``,
the reference's exact constraint order) through the normal path, on the
CPU's plain twin with the 162-tet block of ``small_mesh``: the tables and
bits of ``DenseBody(coloring="ordered")``; ``backend="dense"`` still the
greedy batch; the scene checkpoint; the refusals; one kernel span a
frame."""
import json

import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch import diag, spans
from tetsim_torch.kernels import dense_frame
from tetsim_torch.world import DenseBody

torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
PARAMS = tt.PhysicsParams(num_substeps=2)
BATCH = dict(jitter=0.3, seed=11)
TABLES = ("ids", "irp", "irv", "imc")
STATE = ("pos", "prev_pos", "vel")
SPEC = {"add", "num_bodies", "engine", "backend", "jitter", "seed",
        "density", "_mesh"}  # a batch's construction spec, as before


def _mesh():
    return tt.grid_mesh(3, 3, 3, **SMALL)


def _batch(backend="dense_ordered"):
    world = tt.World(PARAMS, device="cpu")
    batch = world.add_body_batch(_mesh(), 3, engine="neohookean",
                                 backend=backend, **BATCH)
    return world, batch


def _same_tables(a, b) -> bool:
    return all(torch.equal(getattr(a.arrays, k), getattr(b.arrays, k))
               for k in TABLES)


def _same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATE)


def test_ordered_batch_is_the_ordered_dense_body():
    """The batch has the levels of ``DenseBody(coloring="ordered")``, one a
    level of ``mesh.level_schedule``, and steps bit for bit with it."""
    world, batch = _batch()
    mesh = _mesh()
    body = DenseBody(mesh, 3, coloring="ordered", device="cpu", **BATCH)
    assert type(batch) is DenseBody and batch.coloring == "ordered"
    levels = tt.mesh.level_schedule(mesh.tets, mesh.num_particles)
    assert batch.arrays.num_levels == int(levels.max()) + 1
    assert _same_tables(batch, body) and _same_state(batch, body)
    assert world._specs[0]["backend"] == "dense_ordered"
    assert set(world._specs[0]) == SPEC
    world.step(2)
    body.step(PARAMS, 2)
    assert _same_state(batch, body)


def test_dense_is_still_the_greedy_batch():
    """``backend="dense"``: the greedy tables and bits of the batch as it
    was, its spec's keys as before, other tables than the ordered batch's."""
    world, batch = _batch("dense")
    body = DenseBody(_mesh(), 3, coloring="greedy", device="cpu", **BATCH)
    assert batch.coloring == "greedy" and _same_tables(batch, body)
    assert not _same_tables(batch, _batch()[1])
    assert set(world._specs[0]) == SPEC
    world.step(2)
    body.step(PARAMS, 2)
    assert _same_state(batch, body)


def _spec(path) -> dict:
    with np.load(path) as z:
        return json.loads(z["__meta__"].tobytes())["specs"][0]


@pytest.mark.parametrize("backend,coloring", [("dense_ordered", "ordered"),
                                              ("dense", "greedy")])
def test_checkpoint_keeps_the_tables(tmp_path, backend, coloring):
    """save -> ``World.load``: the batch's tables back, the state stepping
    bit for bit with the saved world's, the grab kept."""
    world, batch = _batch(backend)
    batch.set_grab(1, 7, [0.1, 1.0, 0.0])
    world.step(1)
    path = str(tmp_path / f"{backend}.npz")
    world.save(path)
    assert _spec(path)["backend"] == backend
    loaded = tt.World.load(path, device="cpu")
    again = loaded.bodies[0]
    assert type(again) is DenseBody and again.coloring == coloring
    assert _same_tables(again, batch)
    world.step(2)
    loaded.step(2)
    assert _same_state(again, batch)
    assert torch.equal(again.grab_id, batch.grab_id)


@pytest.mark.parametrize("backend", ["dense", "dense_ordered"])
def test_the_dense_backends_refuse_the_polar_engine(backend):
    world = tt.World(PARAMS, device="cpu")
    with pytest.raises(ValueError, match=f"the {backend} backend implements "
                                         "the neohookean engine"):
        world.add_body_batch(_mesh(), 3, engine="polar", backend=backend)
    assert not world.bodies and not world._specs


def test_one_kernel_span_a_frame(tmp_path):
    """A ``diag.trace`` of one frame of the ordered batch holds one
    ``tetsim.kernel.dense_frame`` range."""
    world, _ = _batch()
    with diag.trace(str(tmp_path)) as tr:
        world.step(1)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    name = spans.kernel(dense_frame.__name__)
    assert name == "tetsim.kernel.dense_frame"
    assert sum(1 for e in events if e.get("name") == name
               and e.get("cat") == "user_annotation") == 1
