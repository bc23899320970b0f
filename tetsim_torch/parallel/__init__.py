"""Slab decomposition of the grid engines (counterpart of the x-slab parts
of ``tetsim_tpu/solvers/polar_grid.py``, ``solvers/neohookean_grid.py``,
``kernels/polar_stencil.py`` and ``kernels/nh_stencil.py``).

``SlabMesh`` holds d slabs along the cube-x axis and the device of each; it
takes the place of a one-axis ``jax.sharding.Mesh`` in the steppers
``solvers.polar_grid.make_grid_sharded_step``,
``solvers.neohookean_grid.make_nh_sharded_step``,
``kernels.polar_stencil.make_grid_sharded_stepper`` and
``kernels.nh_stencil.make_nh_sharded_stepper``.  One process drives every
slab, and a device may hold several (``SlabMesh(4)`` puts 4 slabs on one
card); the boundary-plane moves between neighbours replace JAX's
``ppermute``.
"""
from .slabs import SlabMesh  # noqa: F401
