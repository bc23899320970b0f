"""``dragon_nh_ordered``: its plain reference against the port's plain
path on the CPU (the order-preserving levels, the dense twin's frames),
its frozen work counts against the port's, and a tiny cell of the
configuration through the harness on a few-hundred-tet mesh, sound and
broken (the greedy tables, a call that runs fewer frames).  The dragon's
ordered one-hot is 1.78 GB, so nothing here runs the dragon's twin."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import tetsim_torch as tt
import tetsim_torch.world as world_mod
from tetsim_torch.kernels import dense_frame
from tetsim_torch.solvers import dense

from conftest import REPO, copy_checkout
from portbench.lib import cells, harness, scenes, work_dense
from portbench.reference import dragon_nh_ordered as ref_mod

CELL = "dragon_nh_ordered.dense8"
TINY = "box4_ordered.tiny"  # the tiny cell: a 4x4x4 box of 384 tets
TINY_MIX = {"loop": "ahead", "bodies": 2, "backend": "dense_ordered",
            "jitter": 0.5,
            "frames_per_call": 2, "warmup_frames": 3, "start_calls": 1,
            "samples": 2, "trace_seconds": 0.2}
BOX = dict(cell=0.1, origin=(-0.2, 0.2, -0.2))


def _config():
    return dict(cells.resolve(CELL, REPO).config)


def _box():
    """A 4x4x4 box whose 384 tets are shuffled, as a mesh from a tet
    generator is: 78 order-preserving levels against 30 greedy colours, so
    that the two orders differ as on the dragon (703 against 32)."""
    mesh = tt.grid_mesh(4, 4, 4, **BOX)
    order = np.random.RandomState(0).permutation(mesh.num_tets)
    return dataclasses.replace(mesh, tets=mesh.tets[order])


def test_ordered_levels_equal_the_ports_level_schedule():
    mesh = tt.load_dragon()
    ours = ref_mod.ordered_levels(mesh.tets, mesh.num_particles)
    assert np.array_equal(ours, tt.mesh.level_schedule(mesh.tets,
                                                       mesh.num_particles))
    cfg = _config()
    assert ours.max() + 1 == cfg["levels"]
    assert np.bincount(ours).max() == 22


def test_frames_agree_with_the_dense_twin(tmp_path):
    """Three frames of 2 jittered boxes with a grab on both, on the ordered
    tables: the reference against ``dense.frame_reference``, within the bars
    of ``test_dragon_frames_agree_with_the_plain_twin``."""
    mesh = _box()
    path = str(tmp_path / "box.npz")
    tt.save_npz(path, mesh)
    cfg = dict(_config(), mesh=path)
    ref = ref_mod.Reference(cfg, {"bodies": 2, "jitter": 0.5}, REPO, "cpu")
    pos, vel = ref.initial({"seed": 77})
    body = world_mod.DenseBody(mesh, 2, coloring="ordered", jitter=0.5,
                               seed=77, device="cpu")
    assert torch.equal(body.pos.movedim(-1, 0), pos)
    params = scenes.physics(cfg)
    target = np.array([0.1, 0.9, 0.2], np.float32)
    gid = torch.tensor([5, 5], dtype=torch.int32)
    gpos = torch.as_tensor(np.stack([target, target], axis=1))
    state = body.state
    for _ in range(3):
        state = dense.frame_reference(state, body.arrays, params, gid, gpos)
        pos, vel = ref.frame(pos, vel, (5, target))
    assert (state.pos.movedim(-1, 0) - pos).abs().max() < 2e-5
    assert (state.vel.movedim(-1, 0) - vel).abs().max() < 2e-2


@pytest.mark.parametrize("bodies", [1, 8])
def test_dense_counts(bodies):
    """The frozen counts equal ``dense_frame.frame_flops`` /
    ``frame_bytes`` on the dragon's ordered tables."""
    cfg = _config()
    arr = dense.build_dense_arrays(tt.load_dragon(), coloring="ordered",
                                   device="cpu")
    assert arr.num_levels == cfg["levels"]
    params = scenes.physics(cfg)
    assert (work_dense.frame_flops(cfg["tets"], cfg["particles"], 5, bodies)
            == dense_frame.frame_flops(arr, params, bodies))
    assert (work_dense.frame_bytes(cfg["particles"], cfg["tets"], bodies)
            == dense_frame.frame_bytes(arr, bodies))
    assert "onehot" not in vars(arr)


def _tiny_root(dest: str) -> str:
    """A throwaway checkout with ``TINY``: the configuration's files copied
    under a new name, its mesh a 4x4x4 box written into the checkout, a
    two-body mix, the real cell's limits and metrics."""
    root = copy_checkout(dest)
    pb = os.path.join(root, "portbench")
    mesh = _box()
    tt.save_npz(os.path.join(root, "tetsim_tpu", "assets", "box4.npz"), mesh)
    levels = tt.mesh.level_schedule(mesh.tets, mesh.num_particles)
    cfg = dict(_config(), mesh="tetsim_tpu/assets/box4.npz",
               particles=mesh.num_particles, tets=mesh.num_tets,
               levels=int(levels.max()) + 1)
    cfg.pop("name")
    with open(os.path.join(pb, "configs", "box4_ordered.json"), "w") as f:
        json.dump(cfg, f)
    for folder in ("configs", "reference"):
        shutil.copy(os.path.join(pb, folder, "dragon_nh_ordered.py"),
                    os.path.join(pb, folder, "box4_ordered.py"))
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY_MIX, f)
    shutil.copy(os.path.join(pb, "limits", f"{CELL}.json"),
                os.path.join(pb, "limits", f"{TINY}.json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "box4_ordered", "source": "a 4x4x4 box", "reduced": ["tets"],
        "file": "portbench/configs/box4_ordered.json", "why": "CPU tests"})
    bench["workloads"].append({"name": TINY, "config": "box4_ordered",
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return _tiny_root(str(tmp_path))


def _run(root):
    return harness.run_cell(TINY, 2**31 + 23, 0.3, False, root, "cpu",
                            time.perf_counter())


def test_tiny_cell_correct(tiny_root):
    result, compared = _run(tiny_root)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"body_substeps_per_s", "setup_s"}
    assert compared["start_pos"][0] == 0 and compared["start_vel"][0] == 0


def _readings(root):
    return {k: v for k, (v, _) in _run(root)[1].items()}


def test_greedy_tables_are_seen(tiny_root, monkeypatch):
    """The same run on the greedy colouring (``backend="dense"``), another
    Gauss-Seidel order, reads a thousand times the sound run's position
    gaps.  The box deforms far less than the dragon, so here they stay
    inside the dragon's limits; on the card the dragon's greedy tables fail
    them (PERF.md section 2)."""
    sound = _readings(tiny_root)
    real = world_mod.World.add_body_batch

    def greedy(self, *args, **kw):
        return real(self, *args, **dict(kw, backend="dense"))

    monkeypatch.setattr(world_mod.World, "add_body_batch", greedy)
    other = _readings(tiny_root)
    for k in ("first_pos", "frame_pos"):
        assert other[k] > 1000 * sound[k] > 0, k


def test_call_runs_fewer_frames(tiny_root, monkeypatch):
    """``World.step(2)`` that runs 1 frame fails the first calls."""
    real = world_mod.World.step
    monkeypatch.setattr(world_mod.World, "step", lambda self, frames=1: real(
        self, frames - 1 if frames > 1 else frames))
    result, compared = _run(tiny_root)
    assert not result["correct"]
    assert compared["first_pos"][0] > compared["first_pos"][1]


def test_the_parent_fails_at_once_without_the_backend(tiny_root,
                                                     monkeypatch):
    """A port whose ``add_body_batch`` has no ``dense_ordered`` backend (the
    program before this configuration, which raises on an unknown backend)
    refuses the cell in set-up, with no frame run."""
    real = world_mod.World.add_body_batch
    frames = []
    monkeypatch.setattr(world_mod.World, "step",
                        lambda self, n=1: frames.append(n))

    def older(self, mesh, num_bodies, engine="polar", backend="flat", **kw):
        if backend == "dense_ordered":
            raise ValueError(f"unknown backend {backend!r}")
        return real(self, mesh, num_bodies, engine, backend, **kw)

    monkeypatch.setattr(world_mod.World, "add_body_batch", older)
    with pytest.raises(ValueError, match="unknown backend 'dense_ordered'"):
        _run(tiny_root)
    assert not frames


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_lower_precision_reference_runs(tmp_path, dtype):
    """The control's arithmetic gives finite numbers on the box."""
    path = str(tmp_path / "box.npz")
    tt.save_npz(path, _box())
    cfg = dict(_config(), mesh=path)
    low = ref_mod.Reference(cfg, {"bodies": 2, "jitter": 0.5}, REPO, "cpu",
                            dtype=dtype)
    pos, vel = low.frame(*low.initial({"seed": 3}))
    assert pos.dtype == dtype and bool(torch.isfinite(pos).all())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_graph_walk_is_the_walk(card, dtype):
    """On the card the reference's walk of the dragon's 703 levels, replayed
    from its CUDA graph, gives the bits of the walk launched call by call,
    at the first replay and the next."""
    ref = ref_mod.Reference(_config(), {"bodies": 8, "jitter": 0.5}, REPO,
                            card, dtype=dtype)
    pos, _ = ref.initial({"seed": 2**31 + 3})
    gen = torch.Generator(device=card).manual_seed(5)
    pos = pos + (0.01 * torch.rand(pos.shape, generator=gen,
                                   device=card)).to(dtype)
    want = ref._walk(pos.clone())
    for _ in range(2):
        assert torch.equal(ref._graph_walk(pos), want)
