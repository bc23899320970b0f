"""tetsim_torch.roofline on the CPU: the plain twin of the extract_rotation
micro-kernel (``kernels/csrc/extract_rotation.cu``) held against the JAX
grid engine's ``_extract_rotation`` in the same feedback loop; the kernel
itself runs only on the card (``chip_smoke.py`` phase 18)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetsim_tpu.solvers.polar_grid import _extract_rotation
from tetsim_torch import roofline

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)


def _jax_loop(a, passes):
    """scripts/roofline.py's loop: extract_rotation from the identity, then
    a00 += qw * 1e-20, ``passes`` times."""
    a00, fixed = jnp.asarray(a[0]), [jnp.asarray(x) for x in a[1:]]
    for _ in range(passes):
        planes = [a00] + fixed
        q = _extract_rotation([[planes[3 * r + c] for c in range(3)]
                               for r in range(3)])
        a00 = a00 + q[3] * np.float32(1e-20)
    return np.stack([np.asarray(x) for x in q])


def test_twin_matches_jax():
    """16 x 128 lanes, 3 passes: 2e-5 (ROADMAP's polar quaternion bar)."""
    a = roofline.random_planes(16, seed=5, device="cpu")
    count = roofline.launch_count
    q = roofline.extract_rotation(a, 3)
    assert roofline.launch_count == count  # the CPU never launches it
    assert tuple(q.shape) == (4, 16, 128)
    np.testing.assert_allclose(q.numpy(), _jax_loop(a.numpy(), 3), atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(q.numpy(), axis=0), 1.0,
                               atol=1e-5)


def test_wrapper_refuses_cpu_and_counts():
    a = roofline.random_planes(1, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        roofline._extract_rotation_cuda(a, 1)
    assert roofline.extract_rotation_flops(1_048_576) == 1_048_576 * 9 * 136
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal applies where it has none")
    assert roofline.main() == 1  # no card, no result
