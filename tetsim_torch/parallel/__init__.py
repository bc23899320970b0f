"""Multi-device forms of the engines (counterpart of
``tetsim_tpu/parallel/`` and of the x-slab parts of the JAX package's grid
engines).  One process drives every device, and a device may hold several
shards, so one card can run any of them.

``DeviceMesh`` holds devices on named axes, as ``jax.sharding.Mesh``
does: ``make_sharded_step`` steps the polar and Neo-Hookean engines over
its body axis (a batch of bodies split over devices, the fused kernels K1
and K2 on each) and its tet axis (one mesh's tets split over devices: the
polar sums added across shards once per solve, the Neo-Hookean sweep
through ``nh_shard``'s compact per-level exchange).  ``FusedGSBody.shard``
and ``FusedPolarBody.shard`` split a fused batch over a mesh axis.

``SlabMesh`` holds d slabs along the cube-x axis of a grid box and the
device of each; it takes the place of a one-axis ``jax.sharding.Mesh`` in
the steppers ``solvers.polar_grid.make_grid_sharded_step``,
``solvers.neohookean_grid.make_nh_sharded_step``,
``kernels.polar_stencil.make_grid_sharded_stepper`` and
``kernels.nh_stencil.make_nh_sharded_stepper``; the boundary-plane moves
between neighbours replace JAX's ``ppermute``.
"""
from .slabs import SlabMesh  # noqa: F401
from .sharding import (  # noqa: F401
    DeviceMesh,
    make_sharded_step,
    prepare,
    pad_tet_arrays,
    pad_slots,
    pad_quats,
    batch_state,
    batch_controls,
)
from . import nh_shard  # noqa: F401
