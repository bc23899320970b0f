"""The frozen work counts of ``lib/work.py`` equal the port's own
``frame_flops`` / ``frame_bytes`` today, at the cells' shapes."""
from __future__ import annotations

import types

import pytest

import tetsim_torch as tt
from tetsim_torch.kernels import gs_fused, nh_stencil

from conftest import REPO
from portbench.lib import cells, scenes, work


@pytest.mark.parametrize("bodies", [1, 8])
def test_k1_counts(bodies):
    cfg = cells.resolve("dragon_nh.batch8", REPO).config
    mesh = tt.load_dragon()
    arr = tt.build_arrays(mesh, coloring="greedy", device="cpu")
    params = scenes.physics(cfg)
    assert (work.k1_frame_flops(cfg["tets"], cfg["particles"], 5, bodies)
            == gs_fused.frame_flops(arr, params, bodies))
    assert (work.k1_frame_bytes(cfg["tets"], cfg["particles"], 5, bodies, 1)
            == gs_fused.frame_bytes(arr, params, bodies, 1))


def test_k3_counts():
    cfg = cells.resolve("box56_nh.ahead", REPO).config
    nx, ny, nz = cfg["dims"]
    arr = types.SimpleNamespace(  # what the port's counts read of NHGridArrays
        num_tets=6 * nx * ny * nz,
        num_particles=(nx + 1) * (ny + 1) * (nz + 1))
    assert arr.num_tets == cfg["tets"] and arr.num_particles == cfg["particles"]
    params = scenes.physics(cfg)
    assert (work.k3_frame_flops(cfg["dims"], 5, 1)
            == nh_stencil.frame_flops(arr, params, 1))
    assert (work.k3_frame_bytes(cfg["dims"], 5, 1, 1)
            == nh_stencil.frame_bytes(arr, params, 1, 1))


def test_bound():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
