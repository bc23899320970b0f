"""convert.py hands a tetsim_tpu run to tetsim_torch mid-trajectory; and the
port never imports jax or tetsim_tpu."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch import convert
from tetsim_torch.solvers import neohookean as tnh

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # tests/conftest.py small_mesh
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params_dict(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _arrays_dict(arr):
    return {f.name: None if getattr(arr, f.name) is None
            else np.asarray(getattr(arr, f.name)) for f in dataclasses.fields(arr)}


def test_handoff_mid_trajectory():
    """4 frames in JAX with a grab, then the state, params and tables go
    through convert.py and both packages run 4 more frames: 2e-5."""
    mesh = ts.grid_mesh(3, 3, 3, **SMALL)
    arr = ts.build_arrays(mesh)
    jparams = ts.PhysicsParams(num_substeps=5)
    ctrl = ts.Controls(grab_id=np.int32(9), grab_pos=np.float32([0.1, 1.2, 0.0]))
    step = jax.jit(ts.get_engine("neohookean").step_frame)
    state = ts.init_state(mesh)
    for _ in range(4):
        state, _ = step(state, arr, jparams, ctrl)

    params = convert.params_from_numpy(_params_dict(jparams))
    assert params.dt == np.asarray(jparams.dt)
    tstate = convert.state_from_numpy(
        *(np.asarray(x) for x in (state.pos, state.prev_pos, state.vel, state.quats)),
        "cpu")
    tarr = convert.arrays_from_numpy("cpu", **_arrays_dict(arr))
    tctrl = tt.Controls(grab_id=torch.tensor(9, dtype=torch.int32),
                        grab_pos=torch.tensor([0.1, 1.2, 0.0]))
    for _ in range(4):
        state, jv = step(state, arr, jparams, ctrl)
        tstate, tv = tnh.step_frame(tstate, tarr, params, tctrl)
    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(state.pos), atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert tstate.quats.shape == (mesh.num_tets, 4)


def test_arrays_from_numpy_equals_build_arrays():
    mesh = ts.grid_mesh(2, 2, 2, cell=0.2)
    tarr = convert.arrays_from_numpy(
        "cpu", **_arrays_dict(ts.build_arrays(mesh, coloring="greedy")))
    own = tt.build_arrays(tt.grid_mesh(2, 2, 2, cell=0.2), coloring="greedy",
                          device="cpu")
    for f in dataclasses.fields(own):
        if f.name in ("inc_idx", "inc_den"):  # polar tables, not built here
            assert getattr(tarr, f.name) is None and getattr(own, f.name) is None
        else:
            assert torch.equal(getattr(tarr, f.name), getattr(own, f.name)), f.name
    with pytest.raises(ValueError, match="unknown TetArrays"):
        convert.arrays_from_numpy("cpu", tets=np.zeros((1, 4), np.int32),
                                  colors=np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="unknown PhysicsParams"):
        convert.params_from_numpy({"gravity": -9.81, "wind": 1.0})


def test_import_leaves_out_jax_and_tetsim_tpu():
    code = (
        "import importlib, importlib.util, pkgutil, sys, tetsim_torch\n"
        "for m in pkgutil.walk_packages(tetsim_torch.__path__, 'tetsim_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "tetsim_torch.World\n"
        "for name in ('torch_drop_dragon', 'torch_cantilever', "
        "'torch_scale_grid'):\n"
        "    spec = importlib.util.spec_from_file_location(name, "
        "'examples/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tetsim_tpu'))\n"
        "assert not bad, bad\n"
        "grid = ('solvers.polar_grid', 'solvers.neohookean_grid', "
        "'kernels.polar_stencil', 'kernels.nh_stencil', "
        "'kernels.polar_pieces', 'kernels.nh_pieces', 'kernels.gs_ordered', "
        "'checkpoint', 'viewer.server', 'roofline', 'kernels.gs_levels', "
        "'kernels.polar_jacobi', 'parallel', 'parallel.slabs', "
        "'parallel.sharding', 'parallel.nh_shard', 'solvers.dense', "
        "'kernels.dense_frame')\n"
        "missed = [m for m in grid if 'tetsim_torch.' + m not in sys.modules]\n"
        "assert not missed, missed\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
