"""The rest of tetsim_torch's public surface against tetsim_tpu's: mesh IO
(``single_tet_mesh``, ``save_npz`` / ``load_npz``, ``load_tetgen``),
``diag.trace`` and the three ``examples/torch_*.py``.  Mesh IO is exact:
the same arrays, dtypes and shapes as the JAX package's."""
import gzip
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetsim_torch as tt
import tetsim_tpu as ts
from tetsim_torch import diag
from tetsim_torch import mesh as tmesh
from tetsim_tpu import diag as jdiag
from tetsim_tpu import mesh as jmesh

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("verts", "tets", "edges", "vis_tet_ids", "vis_bary", "tris")


def _same_mesh(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_single_tet_mesh_matches_jax():
    _same_mesh(tt.mesh.single_tet_mesh(), jmesh.single_tet_mesh())


def test_npz_round_trip_of_the_dragon_both_ways(tmp_path):
    """The dragon written by either package reads back in both as the
    asset's arrays; a mesh without a surface keeps its None fields."""
    dragon = tt.load_dragon()
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tt.save_npz(ours, dragon)
    ts.save_npz(theirs, ts.load_dragon())
    for path in (ours, theirs):
        _same_mesh(tt.load_npz(path), ts.load_dragon())
        _same_mesh(ts.load_npz(path), dragon)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
    box = tt.grid_mesh(2, 1, 1, with_edges=True)
    tt.save_npz(str(tmp_path / "box.npz"), box)
    _same_mesh(tt.load_npz(str(tmp_path / "box.npz")),
               ts.load_npz(str(tmp_path / "box.npz")))


NODES = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (1.0, 1.0, 1.0)]
TETS = [(0, 1, 2, 3), (1, 2, 4, 3)]  # the second is inverted


def _write_tetgen(tmp_path, base: int):
    node = tmp_path / f"m{base}.node"
    ele = tmp_path / f"m{base}.ele"
    lines = ["# a TetGen mesh", f"{len(NODES)} 3 1 1"]
    lines += [f"{i + base} {x} {y} {z} 0.5 {i % 2}  # node"
              for i, (x, y, z) in enumerate(NODES)]
    node.write_text("\n".join(lines) + "\n")
    lines = [f"{len(TETS)} 4 0", ""]
    lines += [f"{i + base} " + " ".join(str(v + base) for v in t)
              for i, t in enumerate(TETS)]
    ele.write_text("\n".join(lines) + "\n# end\n")
    return str(node), str(ele)


@pytest.mark.parametrize("base", [0, 1])
def test_load_tetgen_matches_jax(tmp_path, base):
    """A .node/.ele pair with comments, attribute and marker columns, 0- or
    1-based, one tet inverted: the JAX package's mesh, the inverted tet
    reoriented to positive volume; a reference outside the nodes raises."""
    node, ele = _write_tetgen(tmp_path, base)
    got, want = tt.load_tetgen(node, ele), ts.load_tetgen(node, ele)
    _same_mesh(got, want)
    np.testing.assert_array_equal(got.tets[1], [1, 4, 2, 3])
    p = got.verts[got.tets]
    assert (np.linalg.det(np.stack([p[:, k] - p[:, 0] for k in (1, 2, 3)],
                                   axis=-1)) > 0).all()
    bad = tmp_path / "bad.ele"
    bad.write_text(f"1 4 0\n0 0 1 2 {len(NODES) + base}\n")
    for load in (tt.load_tetgen, ts.load_tetgen):
        with pytest.raises(ValueError, match="outside"):
            load(node, str(bad))
    empty = tmp_path / "empty.node"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="empty TetGen file"):
        tmesh._read_tetgen_table(str(empty))


def _events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_timeline_like_jax(tmp_path):
    """``diag.trace`` around 3 plain-twin frames of the polar dragon (4
    substeps each) writes
    a Chrome trace into its directory, as the JAX package's writes one
    around JAX work; both leave an exception raised inside to the
    caller."""
    world = tt.World(tt.PhysicsParams(num_substeps=4), device="cpu")
    world.add_body(tt.load_dragon(), engine="polar")
    with diag.trace(str(tmp_path / "port")) as t:
        world.step(3)
    assert os.path.dirname(t.path) == str(tmp_path / "port")
    names = {e.get("name") for e in _events(t.path)}
    assert any(str(n).startswith("aten::") for n in names)

    with jdiag.trace(str(tmp_path / "jax")):
        jnp.arange(8.0).sum().block_until_ready()
    found = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "jax")
             for f in fs if f.endswith(".trace.json.gz")]
    assert found and _events(found[0])

    for trace in (diag.trace, jdiag.trace):
        with pytest.raises(KeyError):
            with trace(str(tmp_path / "raised")):
                raise KeyError("inside")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_examples_run_two_frames_on_the_cpu(tmp_path, capsys):
    """Each example, 2 frames with --device cpu, through the port's public
    API: the dragon of both engines and its checkpoint, the pinned beam
    (its wall does not move, its tip sags), the packed box."""
    ckpt = str(tmp_path / "dragon.npz")
    world = _example("torch_drop_dragon").main(
        ["--device", "cpu", "--frames", "2", "--checkpoint", ckpt])
    state = tt.init_state(tt.load_dragon(), "cpu")
    from tetsim_torch import checkpoint

    got = checkpoint.load(ckpt, like=state)
    torch.testing.assert_close(got.pos, world.bodies[0].state.pos, rtol=0,
                               atol=0)
    beam = _example("torch_cantilever").main(
        ["--device", "cpu", "--frames", "2", "--nx", "6"])
    assert torch.isfinite(beam.pos).all()
    box = _example("torch_scale_grid").main(
        ["--device", "cpu", "--frames", "2", "--n", "2"])
    assert box.diagnostics()["body0"]["nan"] is False
    out = capsys.readouterr().out
    for text in ("[neohookean ]", "[polar      ]", "root wall held",
                 "tip sagged", "grid 2^3: 48 tets", "settled:"):
        assert text in out, text
