"""The plain references against the port's plain path at tiny sizes, on the
CPU.  The comparison with the port is made here only: the references
import nothing of tetsim_torch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tetsim_torch as tt
from tetsim_torch.kernels import gs_fused, nh_stencil
from tetsim_torch.solvers.neohookean_grid import build_nh_grid_arrays
from tetsim_torch.solvers.polar_grid import planes, unplanes

from conftest import REPO
from portbench.lib import cells, scenes
from portbench.reference import _xpbd

BOX = {"dims": [2, 2, 2], "cell": 0.1, "origin": [-0.1, 0.3, -0.1],
       "num_substeps": 5}


def _config(name, **over):
    cfg = dict(cells.resolve(
        {"dragon_nh": "dragon_nh.batch8",
         "box56_nh": "box56_nh.ahead"}[name], REPO).config)
    cfg.update(over)
    return cfg


def _box_reference(**over):
    cell = cells.resolve("box56_nh.viewer", REPO)
    cfg = dict(cell.config, **BOX, **over)
    return cfg, cell.reference.Reference(cfg, {"bodies": 1}, REPO, "cpu")


def test_first_fit_colors_equal_the_ports_greedy():
    mesh = tt.load_dragon()
    ours = _xpbd.first_fit_colors(mesh.tets)
    assert np.array_equal(ours, tt.mesh.greedy_color(mesh.tets,
                                                     mesh.num_particles))


def test_grid_and_surface_equal_the_ports():
    from portbench.reference import box56_nh as ref_box

    verts, tets, kind, parity = ref_box.grid((3, 2, 4), 0.05, (0.1, 0.2, 0.3))
    mesh = tt.mesh.with_boundary_surface(tt.grid_mesh(
        3, 2, 4, cell=0.05, origin=(0.1, 0.2, 0.3)))
    assert np.array_equal(verts, mesh.verts)
    assert np.array_equal(tets, mesh.tets)
    pids, tris = ref_box.boundary(tets, verts)
    skin = mesh.tets[mesh.vis_tet_ids]
    w = np.concatenate([mesh.vis_bary, 1 - mesh.vis_bary.sum(1, keepdims=True)],
                       axis=1)
    assert np.array_equal(skin[np.arange(len(skin)), w.argmax(1)], pids)
    assert np.array_equal(_rotated(tris), _rotated(mesh.tris))


def _rotated(tris):
    """Each triangle turned so that its least vertex comes first (the same
    winding)."""
    k = tris.argmin(1)
    return np.stack([tris[np.arange(len(tris)), (k + j) % 3]
                     for j in range(3)], 1)


def test_dragon_frames_agree_with_the_plain_twin():
    """Three frames of 2 jittered dragons with a grab on body 0: the
    reference against ``gs_fused.gs_frame_reference`` on the port's
    greedy schedule."""
    cfg = _config("dragon_nh")
    traffic = {"bodies": 2, "jitter": 0.5}
    ref = cells.resolve("dragon_nh.batch8", REPO).reference.Reference(
        cfg, traffic, REPO, "cpu")
    pos, vel = ref.initial({"seed": 77})
    batch = gs_fused.FusedGSBody(tt.load_dragon(), 2, jitter=0.5, seed=77,
                           device="cpu")
    assert torch.equal(batch.pos, pos)
    params = scenes.physics(cfg)
    gid = torch.tensor([[5], [5]], dtype=torch.int32)
    target = np.array([0.1, 0.9, 0.2], np.float32)
    gpos = torch.as_tensor(np.stack([target, target]))[:, None, :]
    p, v = batch.pos, batch.vel
    for _ in range(3):
        p, _, v, _ = gs_fused.gs_frame_reference(p, v, batch.arrays, params,
                                                 gid, gpos)
        pos, vel = ref.frame(pos, vel, (5, target))
    assert (p - pos).abs().max() < 2e-5
    assert (v - vel).abs().max() < 2e-2


def test_box_frames_agree_with_the_plain_twin():
    """Three frames of a 2x2x2 box from seeded velocities with a grab: the
    reference against ``nh_stencil.grid_frame_reference``."""
    cfg, ref = _box_reference()
    vel0 = scenes.seeded_velocities(3, (1, 27, 3), 0.1, "cpu")
    pos, vel = ref.initial({"vel": vel0})
    mesh = tt.grid_mesh(2, 2, 2, cell=0.1, origin=(-0.1, 0.3, -0.1))
    arr = build_nh_grid_arrays(mesh, (2, 2, 2), device="cpu")
    params = scenes.physics(cfg)
    p, v = planes(pos), planes(vel)
    target = np.array([0.0, 0.6, 0.0], np.float32)
    gid = torch.tensor([[26]], dtype=torch.int32)
    gpos = torch.as_tensor(target)[None, None]
    for _ in range(3):
        p, _, v, _ = nh_stencil.grid_frame_reference(p, v, arr, params, gid,
                                                     gpos)
        pos, vel = ref.frame(pos, vel, (26, target))
    assert (unplanes(p) - pos).abs().max() < 1e-5
    assert (unplanes(v) - vel).abs().max() < 1e-3


def test_exports_agree_with_the_ports():
    """The skinned surface and normals of a deformed state: the dragon's
    and the box's against the port's export."""
    from tetsim_torch.world import _Surface

    cfg = _config("dragon_nh")
    ref = cells.resolve("dragon_nh.batch8", REPO).reference.Reference(
        cfg, {"bodies": 1}, REPO, "cpu")
    mesh = tt.load_dragon()
    gen = torch.Generator().manual_seed(1)
    pos = torch.as_tensor(mesh.verts) + 0.01 * torch.rand(
        mesh.verts.shape, generator=gen)
    want = _Surface(mesh, "cpu").render_data(pos)
    got = ref.export(pos)
    assert (got[0] - torch.as_tensor(want[0])).abs().max() < 1e-6
    assert (got[1] - torch.as_tensor(want[1])).abs().max() < 1e-4

    _, box = _box_reference()
    bmesh = tt.mesh.with_boundary_surface(
        tt.grid_mesh(2, 2, 2, cell=0.1, origin=(-0.1, 0.3, -0.1)))
    bpos = torch.as_tensor(bmesh.verts) + 0.01 * torch.rand(
        bmesh.verts.shape, generator=gen)
    want = _Surface(bmesh, "cpu").render_data(bpos)
    got = box.export(bpos)
    assert (got[0] - torch.as_tensor(want[0])).abs().max() == 0
    assert (got[1] - torch.as_tensor(want[1])).abs().max() < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_lower_precision_reference_runs(dtype):
    """The control's arithmetic gives finite numbers on the box."""
    cfg, low = _box_reference()
    low = type(low)(cfg, {"bodies": 1}, REPO, "cpu", dtype=dtype)
    pos, vel = low.initial({"vel": torch.zeros(1, 27, 3)})
    pos, vel = low.frame(pos, vel)
    assert pos.dtype == dtype and bool(torch.isfinite(pos).all())
