"""tetsim_torch's plain Neo-Hookean engine vs tetsim_tpu's XLA engine on the
same inputs, made with numpy from fixed seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_tpu.solvers import common as jcommon
from tetsim_tpu.solvers import neohookean as jnh
from tetsim_torch.solvers import common as tcommon
from tetsim_torch.solvers import neohookean as tnh

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # tests/conftest.py small_mesh


def test_params_dt_and_gamma_match_jax():
    """dt and gamma are f32 computations with the JAX operation order."""
    for kw in ({}, {"num_substeps": 20}, {"time_scale": 0.7, "num_substeps": 3},
               {"vol_compliance": 1e-6, "time_step": 1 / 90}):
        j = ts.PhysicsParams(**{k: v if k == "num_substeps" else jnp.float32(v)
                                for k, v in kw.items()})
        t = tt.PhysicsParams(**kw)
        assert t.dt.dtype == np.float32
        assert t.dt == np.asarray(j.dt)
        assert t.gamma == np.asarray(j.vol_compliance / j.dev_compliance)
    assert tt.default_cpu_params().num_substeps == 5
    assert tt.default_gpu_params().num_substeps == 20


def test_solve_tet_batch_random_tets():
    """512 seeded random tets: deltas and det F - 1 within 1e-6."""
    rng = np.random.RandomState(0)
    m = 512
    # dragon-sized tets (edges ~0.1) under a few percent of random strain
    corners = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) * 0.1
    rest = (corners + rng.uniform(-0.02, 0.02, (m, 4, 3))
            + rng.uniform(-1, 1, (m, 1, 3))).astype(np.float32)
    d = np.stack([rest[:, k] - rest[:, 0] for k in (1, 2, 3)], axis=-1)
    p = (rest + rng.normal(0, 0.002, rest.shape)).astype(np.float32)
    irp = np.linalg.inv(d).astype(np.float32)
    irv = np.abs(6.0 / np.linalg.det(d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (m, 4)).astype(np.float32)
    w[::7, 0] = 0.0  # some pinned corners
    dt = np.float32(1 / 300)
    for kw in ({}, {"vol_compliance": 1e-6}):
        jp = ts.PhysicsParams(**{k: jnp.float32(v) for k, v in kw.items()})
        tp = tt.PhysicsParams(**kw)
        jd, jv = jax.jit(jnh.solve_tet_batch)(p, irp, irv, w, dt, jp)
        td, tv = tnh.solve_tet_batch(*(torch.as_tensor(x) for x in (p, irp, irv, w)),
                                     dt, tp)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_common_phases_match():
    """predict (with the inv_mass gate), collide (bounds, ground, friction)
    and apply_grab (scalar and vector) vs tetsim_tpu.solvers.common."""
    rng = np.random.RandomState(1)
    n = 64
    pos = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-0.5, 1.0, n)
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, n).astype(np.float32)
    im[::5] = 0.0
    jp, tp = ts.PhysicsParams(), tt.PhysicsParams()
    dt = tp.dt
    jr = jcommon.predict(jnp.asarray(pos), jnp.asarray(vel), jp.dt, jp,
                         inv_mass=jnp.asarray(im))
    tr = tcommon.predict(torch.as_tensor(pos), torch.as_tensor(vel), dt, tp,
                         inv_mass=torch.as_tensor(im))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    prev = pos + rng.normal(0, 0.01, pos.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tcommon.collide(torch.as_tensor(pos), torch.as_tensor(prev), dt, tp).numpy(),
        np.asarray(jcommon.collide(jnp.asarray(pos), jnp.asarray(prev), jp.dt, jp)))
    for gid, gpos in ((np.int32(7), np.float32([0.1, 2.0, -0.3])),
                      (np.int32([3, -1, 60]),
                       rng.uniform(-1, 1, (3, 3)).astype(np.float32))):
        j = jcommon.apply_grab(jnp.asarray(pos), ts.Controls(
            grab_id=jnp.asarray(gid), grab_pos=jnp.asarray(gpos)))
        t = tcommon.apply_grab(torch.as_tensor(pos), tt.Controls(
            grab_id=torch.as_tensor(gid), grab_pos=torch.as_tensor(gpos)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _run_both(coloring, frames, substeps, grab=None, pinned=None):
    jm, tm = ts.grid_mesh(3, 3, 3, **SMALL), tt.grid_mesh(3, 3, 3, **SMALL)
    jarr = ts.build_arrays(jm, coloring=coloring, pinned=pinned)
    tarr = tt.build_arrays(tm, coloring=coloring, pinned=pinned, device="cpu")
    js, tsx = ts.init_state(jm), tt.init_state(tm, "cpu")
    jc, tc = ts.Controls.none(), tt.Controls.none("cpu")
    if grab is not None:
        jc = ts.Controls(grab_id=np.int32(grab[0]), grab_pos=np.float32(grab[1]))
        tc = tt.Controls(grab_id=torch.tensor(grab[0], dtype=torch.int32),
                         grab_pos=torch.tensor(grab[1], dtype=torch.float32))
    jparams = ts.PhysicsParams(num_substeps=substeps)
    tparams = tt.PhysicsParams(num_substeps=substeps)
    step = jax.jit(jnh.step_frame)
    for _ in range(frames):
        js, jv = step(js, jarr, jparams, jc)
        tsx, tv = tnh.step_frame(tsx, tarr, tparams, tc)
    return js, jv, tsx, tv, tparams.dt


def test_step_frame_matches_xla_greedy():
    """3 frames x 2 substeps, greedy: positions 2e-5, vol_errs 1e-5."""
    js, jv, tsx, tv, dt = _run_both("greedy", frames=3, substeps=2)
    assert tv.shape == (2,)
    np.testing.assert_allclose(tsx.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(tsx.prev_pos.numpy(), np.asarray(js.prev_pos), atol=2e-5)
    # velocity is (pos - prev) / dt: the position tolerance scaled by 1/dt
    np.testing.assert_allclose(tsx.vel.numpy(), np.asarray(js.vel), atol=2e-5 / dt)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_step_frame_matches_xla_ordered_grab_pinned():
    """Ordered schedule with a pinned particle and a grab, 2 frames x 5."""
    js, jv, tsx, tv, _ = _run_both("ordered", frames=2, substeps=5,
                                   grab=(5, [0.2, 1.4, 0.1]), pinned=[0])
    np.testing.assert_allclose(tsx.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(tsx.pos[5].numpy(), np.float32([0.2, 1.4, 0.1]))
    np.testing.assert_array_equal(tsx.pos[0].numpy(),
                                  tt.grid_mesh(3, 3, 3, **SMALL).verts[0])


def test_get_engine_and_non_cpu_route():
    assert tt.get_engine("neohookean") is tnh
    with pytest.raises(ValueError, match="unknown engine 'golden'"):
        tt.get_engine("golden")
    # a state on any device other than the CPU goes to the kernel, which
    # refuses a device it cannot launch on instead of running the plain path
    m = tt.grid_mesh(1, 1, 1)
    arr = tt.build_arrays(m, coloring="greedy", device="meta")
    state = tt.init_state(m, "meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tnh.step_frame(state, arr, tt.PhysicsParams(), tt.Controls.none("meta"))
