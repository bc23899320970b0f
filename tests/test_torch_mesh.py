"""tetsim_torch mesh layer vs tetsim_tpu: the meshes, the f32 rest constants
and the integer schedule tables must be exactly equal."""
import os

import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import mesh as tmesh
from tetsim_torch import native as tnative

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # tests/conftest.py small_mesh


def _meshes(name):
    if name == "dragon":
        return ts.load_dragon(), tt.load_dragon()
    return ts.grid_mesh(3, 3, 3, **SMALL), tt.grid_mesh(3, 3, 3, **SMALL)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def test_load_dragon_equal():
    ref, port = ts.load_dragon(), tt.load_dragon()
    assert (port.num_particles, port.num_tets, port.num_surface_verts) == (
        1234, 3840, 29800)
    for f in ("verts", "tets", "edges", "vis_tet_ids", "vis_bary", "tris"):
        _assert_same(getattr(ref, f), getattr(port, f), f)


@pytest.mark.parametrize("dims,with_edges", [((3, 3, 3), False), ((2, 3, 4), True)])
def test_grid_mesh_equal(dims, with_edges):
    ref = ts.grid_mesh(*dims, cell=0.2, origin=(0.1, 0.3, -0.2), with_edges=with_edges)
    port = tt.grid_mesh(*dims, cell=0.2, origin=(0.1, 0.3, -0.2), with_edges=with_edges)
    _assert_same(ref.verts, port.verts, "verts")
    _assert_same(ref.tets, port.tets, "tets")
    if with_edges:
        _assert_same(ref.edges, port.edges, "edges")
    else:
        assert port.edges is None


@pytest.mark.parametrize("kw", [
    dict(n=8, radii=(0.4, 0.3, 0.35), center=(0.0, 0.8, 0.0)),
    dict(n=10, radii=(0.4, 0.35, 0.45), with_edges=True),
    dict(n=6, cell=0.17, center=(0.1, 0.9, -0.2)),
])
def test_ellipsoid_and_surface_equal(kw):
    """ellipsoid_mesh (a masked grid) and with_boundary_surface give the JAX
    package's arrays exactly."""
    ref, port = ts.ellipsoid_mesh(**kw), tt.ellipsoid_mesh(**kw)
    for f in ("verts", "tets", "edges"):
        a, b = getattr(ref, f), getattr(port, f)
        if a is None:
            assert b is None
        else:
            _assert_same(a, b, f)
    ref, port = ts.with_boundary_surface(ref), tt.with_boundary_surface(port)
    for f in ("vis_tet_ids", "vis_bary", "tris"):
        _assert_same(getattr(ref, f), getattr(port, f), f)
    assert port.num_surface_verts > 0


def test_masked_grid_mesh_equal_and_refusals():
    def keep(c):
        return (c[:, 0] + c[:, 1] > 0.35) | (c[:, 2] < 0.15)

    args = (3, 4, 2, keep)
    ref = ts.masked_grid_mesh(*args, cell=0.15, origin=(0.0, 0.1, 0.0),
                              with_edges=True)
    port = tt.masked_grid_mesh(*args, cell=0.15, origin=(0.0, 0.1, 0.0),
                               with_edges=True)
    for f in ("verts", "tets", "edges"):
        _assert_same(getattr(ref, f), getattr(port, f), f)
    assert port.num_tets < 6 * 3 * 4 * 2
    _assert_same(ts.with_boundary_surface(ts.grid_mesh(2, 2, 2)).tris,
                 tt.with_boundary_surface(tt.grid_mesh(2, 2, 2)).tris,
                 "grid surface tris")
    with pytest.raises(ValueError, match="rejected every cube"):
        tt.masked_grid_mesh(2, 2, 2, lambda c: np.zeros(len(c), bool))
    with pytest.raises(ValueError, match="must return bool"):
        tt.masked_grid_mesh(2, 2, 2, lambda c: np.ones(3, bool))


@pytest.mark.parametrize("name", ["dragon", "small"])
def test_rest_state_equal(name):
    ref_mesh, port_mesh = _meshes(name)
    pinned = [0, 3]
    for r, p in zip(ts.mesh.rest_state(ref_mesh, pinned=pinned),
                    tmesh.rest_state(port_mesh, pinned=pinned)):
        _assert_same(r, p, "rest_state")


@pytest.mark.parametrize("coloring", ["ordered", "greedy"])
@pytest.mark.parametrize("name", ["dragon", "small"])
def test_schedule_tables_equal(name, coloring):
    ref_mesh, port_mesh = _meshes(name)
    ref = ts.build_arrays(ref_mesh, coloring=coloring)
    port = tt.build_arrays(port_mesh, coloring=coloring, device="cpu")
    for f in ("tets", "inv_rest_pose", "inv_rest_volume", "rest_volume",
              "inv_mass", "rest_centered", "slot_tets", "slot_inv_rest_pose",
              "slot_inv_rest_volume", "slot_valid", "slot_inv", "slot_inv_mass"):
        _assert_same(getattr(ref, f), getattr(port, f).numpy(), f)
    if name == "dragon":
        expect = (703, 22) if coloring == "ordered" else (32, 228)
        assert tuple(port.slot_valid.shape) == expect


def test_python_fallback_matches_native(monkeypatch):
    """The pure-Python colouring gives the native library's tables."""
    m = tt.grid_mesh(3, 3, 3, **SMALL)
    assert tnative.available()
    native = (tmesh.level_schedule(m.tets, m.num_particles),
              tmesh.greedy_color(m.tets, m.num_particles))
    slots = [tmesh.color_slots(c) for c in native]
    for fn in ("level_schedule", "greedy_color", "color_slots"):
        monkeypatch.setattr(tnative, fn, lambda *a: None)
    py = (tmesh.level_schedule(m.tets, m.num_particles),
          tmesh.greedy_color(m.tets, m.num_particles))
    for a, b in zip(native, py):
        _assert_same(a, b, "colors")
    for c, s in zip(py, slots):
        _assert_same(tmesh.color_slots(c), s, "color_slots")


def test_build_arrays_options_and_to():
    m = tt.grid_mesh(1, 1, 2)
    none = tt.build_arrays(m, coloring=None, device="cpu")
    assert none.slot_tets is None and none.slot_inv is None
    with pytest.raises(ValueError, match="unknown coloring"):
        tt.build_arrays(m, coloring="rainbow", device="cpu")
    arr = tt.build_arrays(m, coloring="greedy", device="cpu")
    moved = arr.to("cpu")
    assert moved.num_particles == m.num_particles and moved.num_tets == m.num_tets
    assert moved.inv_mass.device == torch.device("cpu")
    assert torch.equal(moved.slot_inv, arr.slot_inv)
    assert none.to("cpu").slot_valid is None


def test_port_coloring_source_gives_the_reference_colours():
    """The port builds its own copy of coloring.cpp; its tables equal the
    ones the JAX package's library gives on the dragon."""
    from tetsim_tpu import native as jnative

    assert tnative._SRC.startswith(os.path.dirname(tt.__file__) + os.sep)
    m = tt.load_dragon()
    assert tnative.available() and jnative.available()
    for fn in ("level_schedule", "greedy_color"):
        port = getattr(tnative, fn)(m.tets, m.num_particles)
        ref = getattr(jnative, fn)(m.tets, m.num_particles)
        _assert_same(ref, port, fn)
        _assert_same(jnative.color_slots(ref), tnative.color_slots(port),
                     f"color_slots of {fn}")
