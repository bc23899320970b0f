"""The comparison catches a broken timed path.  Each test skips the
harness's look for a card, drives the rest of a run of a tiny cell on the
CPU with the port's plain path broken underneath, and sees ``correct``
come out false; the first sees it true with nothing broken.  The faults
the cells can have: a step that returns its state unchanged; a call of
k frames that runs fewer; half of the batch left out; an answer altered
where it is produced (a position, an exported normal, the grabbed
particle, the grab's target).  No cell spans chips, so no
exchange between chips can be left out."""
from __future__ import annotations

import time

import pytest
import torch

import tetsim_torch.world as world_mod
from tetsim_torch.kernels import gs_fused, nh_stencil

from portbench.lib import harness


def _run(root, cell, seed=4242):
    result, compared = harness.run_cell(cell, seed, 0.3, False, root, "cpu",
                                        time.perf_counter())
    return result, compared


def _unchanged(pos, vel, arr, params, grab_id, grab_pos, *rest, **kw):
    return pos, pos, vel, pos.new_zeros((pos.shape[0], params.num_substeps))


@pytest.mark.parametrize("cell", ["dragon_nh.tiny2", "box2_nh.tinyview"])
def test_sound_run_is_correct(bench_root, cell):
    assert _run(bench_root, cell)[0]["correct"]


@pytest.mark.parametrize("cell,module,name", [
    ("dragon_nh.tiny2", gs_fused, "gs_frame"),
    ("dragon_nh.tinyview", gs_fused, "gs_frame"),
    ("box2_nh.tinyahead", nh_stencil, "grid_frame"),
])
def test_state_returned_unchanged(bench_root, monkeypatch, cell, module,
                                  name):
    """Caught by the first frames and by the window's frames."""
    monkeypatch.setattr(module, name, _unchanged)
    result, compared = _run(bench_root, cell)
    assert not result["correct"]
    for k in ("first_pos", "frame_pos"):
        assert compared[k][0] > compared[k][1]


@pytest.mark.parametrize("cell", ["dragon_nh.tiny2", "box2_nh.tinyahead"])
def test_call_runs_fewer_frames(bench_root, monkeypatch, cell):
    """``World.step(k)`` that runs k - 1 frames where k > 1, as a fold of
    frames that skips one would: caught by the first calls and by the
    window's calls, which go through the timed call."""
    real = world_mod.World.step

    def short(self, frames=1):
        return real(self, frames - 1 if frames > 1 else frames)

    monkeypatch.setattr(world_mod.World, "step", short)
    result, compared = _run(bench_root, cell)
    assert not result["correct"]
    for k in ("first_pos", "frame_pos"):
        assert compared[k][0] > compared[k][1]


def test_half_the_batch_left_out(bench_root, monkeypatch):
    real = gs_fused.gs_frame

    def half(pos, vel, arr, params, grab_id, grab_pos):
        k = pos.shape[0] // 2
        p, q, v, e = real(pos[:k], vel[:k], arr, params, grab_id[:k],
                          grab_pos[:k])
        return (torch.cat([p, pos[k:]]), torch.cat([q, pos[k:]]),
                torch.cat([v, vel[k:]]), e)

    monkeypatch.setattr(gs_fused, "gs_frame", half)
    result, compared = _run(bench_root, "dragon_nh.tiny2")
    assert not result["correct"]
    assert compared["first_pos"][0] > compared["first_pos"][1]


@pytest.mark.parametrize("cell,module,name", [
    ("dragon_nh.tiny2", gs_fused, "gs_frame"),
    ("box2_nh.tinyahead", nh_stencil, "grid_frame"),
])
def test_position_altered(bench_root, monkeypatch, cell, module, name):
    real = getattr(module, name)

    def nudged(*args, **kw):
        pos, prev, vel, err = real(*args, **kw)
        pos = pos.clone()
        pos.view(-1)[7] += 0.05  # one coordinate of one particle, by 5 cm
        return pos, prev, vel, err

    monkeypatch.setattr(module, name, nudged)
    result, _ = _run(bench_root, cell)
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["dragon_nh.tinyview", "box2_nh.tinyview"])
def test_export_altered(bench_root, monkeypatch, cell):
    real = world_mod._surface_render_data

    def tilted(*args):
        out = real(*args).clone()
        out[1, 0] = -out[1, 0]  # one vertex's normal flipped
        return out

    monkeypatch.setattr(world_mod, "_surface_render_data", tilted)
    result, compared = _run(bench_root, cell)
    assert not result["correct"]
    assert compared["export_normals"][0] > compared["export_normals"][1]


@pytest.mark.parametrize("cell", ["dragon_nh.tinyview", "box2_nh.tinyview"])
def test_wrong_particle_grabbed(bench_root, monkeypatch, cell):
    real = world_mod._nearest_particle

    def next_one(pos, point):
        return (real(pos, point) + 1) % pos.shape[0]

    monkeypatch.setattr(world_mod, "_nearest_particle", next_one)
    result, compared = _run(bench_root, cell)
    assert not result["correct"]
    assert compared["frame_pos"][0] > compared["frame_pos"][1]


@pytest.mark.parametrize("cell", ["dragon_nh.tinyview", "box2_nh.tinyview"])
def test_grab_target_altered(bench_root, monkeypatch, cell):
    """A grab's target 1 mm off where the port takes it in: the exact
    ``grab_pos`` catches it."""
    real = world_mod._point

    def off(point, device):
        return real(point, device) + 1e-3

    monkeypatch.setattr(world_mod, "_point", off)
    result, compared = _run(bench_root, cell)
    assert not result["correct"]
    assert compared["grab_pos"][0] > compared["grab_pos"][1] == 0.0
