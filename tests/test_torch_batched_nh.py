"""tetsim_torch's flat Neo-Hookean batch (``add_body_batch(...,
engine="neohookean", backend="flat")``, ``BatchedBody``) against the JAX
package's on the same seeded scene: K1's [B, N] batch with the single
mesh's ordered tables gives the flat mesh's Gauss-Seidel order, so the plain
twin is held to the JAX flat batch at the Neo-Hookean bar, positions 2e-5."""
import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tetsim_torch.kernels import gs_fused
from tetsim_torch.world import BatchedBody

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_flat(dragon):
    """The JAX flat batch of 3 jittered dragons with a grab on body 1,
    before and after 2 frames (computed once for the module)."""
    jw = ts.World(ts.PhysicsParams())
    batch = jw.add_body_batch(dragon, 3, engine="neohookean", backend="flat",
                              jitter=0.1, seed=1)
    batch.start_grab(1, [0.1, 1.3, 0.0])
    start = np.asarray(batch.positions).copy()
    for _ in range(2):
        batch.step(jw.params)
    return jw, batch, start


def test_flat_nh_batch_matches_jax(jax_flat):
    """Same start (the jitter draws alike), same grab; 2 frames: pos 2e-5,
    each grabbed particle on its target."""
    _, jb, start = jax_flat
    world = tt.World(tt.PhysicsParams(), device="cpu")
    batch = world.add_body_batch(tt.load_dragon(), 3, engine="neohookean",
                                 backend="flat", jitter=0.1, seed=1)
    assert isinstance(batch, BatchedBody) and batch.quats is None
    np.testing.assert_array_equal(batch.positions, start)
    pid = batch.start_grab(1, [0.1, 1.3, 0.0])
    assert pid == int(np.asarray(jb.controls.grab_id)[1]) - jb._n
    world.step(2)
    np.testing.assert_allclose(batch.positions, np.asarray(jb.positions),
                               atol=2e-5)
    assert batch.last_diag.shape == (3, 5)
    np.testing.assert_array_equal(batch.positions[1, pid],
                                  np.float32([0.1, 1.3, 0.0]))


def test_flat_nh_batch_is_the_ordered_fused_batch():
    """BatchedBody(neohookean) and FusedGSBody(coloring="ordered") from the
    same state run the same frame: bitwise equal on the CPU."""
    dragon = tt.load_dragon()
    flat = BatchedBody(dragon, 2, engine="neohookean", jitter=0.2, seed=4,
                       device="cpu")
    fused = gs_fused.FusedGSBody(dragon, 2, coloring="ordered", jitter=0.2,
                                 seed=4, device="cpu")
    params = tt.PhysicsParams()
    flat.step(params)
    fused.step(params)
    assert torch.equal(flat.pos, fused.pos) and torch.equal(flat.vel, fused.vel)
    with pytest.raises(ValueError, match="polar and neohookean"):
        BatchedBody(dragon, 2, engine="neohookean_grid", device="cpu")


def test_jax_world_file_with_flat_nh_batch_loads(jax_flat, tmp_path):
    """The JAX world (flat NH batch, stepped, with a grab) loads in the port
    with equal states and grabs, steps, and saves a file the JAX package
    reads back with the same keys, shapes and states."""
    jw, jb, _ = jax_flat
    path = str(tmp_path / "flat_nh.npz")
    jw.save(path)
    tw = tt.World.load(path, device="cpu")
    tb = tw.bodies[0]
    assert type(tb).__name__ == "BatchedBody" and tb.engine == "neohookean"
    np.testing.assert_array_equal(tb.positions, np.asarray(jb.positions))
    np.testing.assert_array_equal(tb.grab_id[:, 0].numpy(),
                                  np.asarray(jb.controls.grab_id)
                                  - np.where(np.asarray(jb.controls.grab_id)
                                             >= 0, jb._n * np.arange(3), 0))
    back = str(tmp_path / "back.npz")
    tw.save(back)
    with np.load(path) as a, np.load(back) as b:
        keys = sorted(k for k in a.files if k.startswith("b0."))
        assert keys == sorted(k for k in b.files if k.startswith("b0."))
        for k in keys:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)
    tw.step(1)
    assert not tw.diagnostics()["body0"]["nan"]
