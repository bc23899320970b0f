"""tetsim_torch — the PyTorch/CUDA port of tetsim_tpu.

The same XPBD tetrahedral soft-body simulator on one NVIDIA GPU: stable
Neo-Hookean XPBD with graph-coloured Gauss-Seidel and Müller polar shape
matching with Jacobi iteration, ground/bounds collision with friction, grab
constraints, barycentric surface skinning and batched bodies.  Plain torch
runs on the CPU; on CUDA tensors a whole frame is one launch of a
hand-written kernel (``kernels/csrc/gs_frame.cu``,
``kernels/csrc/polar_frame.cu``).  A substep of a structured grid box
(``World.add_grid_body``) is two launches of
``kernels/csrc/polar_stencil.cu`` (K4); a Neo-Hookean frame of one is one
cooperative launch of ``kernels/csrc/nh_stencil.cu`` (K3).  One large
unstructured mesh (``ellipsoid_mesh``, a million tets) runs through the
pieces engines: a polar substep is one launch of
``kernels/csrc/polar_pieces.cu`` (K6) between torch ops, a Neo-Hookean
frame one cooperative launch of ``kernels/csrc/nh_pieces.cu`` (K5) that
carries the whole substep.  Eight bodies in the reference's exact
constraint order (``add_body_batch(..., backend="fused_ordered")``) are
one launch of ``kernels/csrc/gs_ordered.cu`` per frame.  A grid box also
runs in x-slabs (``parallel.SlabMesh``, one process driving every slab,
several slabs to a card if need be) through
``solvers.polar_grid.make_grid_sharded_step``,
``solvers.neohookean_grid.make_nh_sharded_step`` and their kernel forms in
``kernels/polar_stencil.py`` (K4a: two launches per substep and card,
one host call per frame) and ``kernels/nh_stencil.py`` (K3s: one
cooperative launch per frame and card); a body too large for one
block's shared memory runs through ``kernels/csrc/gs_levels.cu`` (one
launch per frame) or ``kernels/csrc/polar_jacobi.cu`` (one cooperative
launch per frame).  ``add_body_batch(..., backend="dense")`` batches bodies
in columns through the dense engine (``solvers/dense.py``, ``DenseBody``):
one launch of ``kernels/csrc/dense_frame.cu`` a frame on the card, each
level gathered and scattered by index, a body's positions in the block's
shared memory or, past 19,370 particles, in a global scratch (the one-hot
products are its plain twin's, built only when the twin runs), and
``backend="dense_ordered"`` on the order-preserving levels.
``parallel.DeviceMesh`` holds devices on named
axes, as ``jax.sharding.Mesh`` does: ``parallel.make_sharded_step`` splits
a batch of bodies (the body axis, K1 / K2 on each device) or one mesh's
tets (the tet axis, in plain torch, as the JAX package runs it in XLA)
over them, and ``FusedGSBody.shard`` / ``FusedPolarBody.shard`` split a
fused batch.  ``World.save`` / ``load`` write and read scene checkpoints
in the JAX package's format, ``save_npz`` / ``load_npz`` / ``load_tetgen``
read and write meshes, ``diag.trace`` writes a timeline, and ``python -m
tetsim_torch.viewer.server`` serves the browser viewer.  The entry points run on the card unless the
caller passes ``device="cpu"``.  The package imports neither jax nor
tetsim_tpu; it reads the dragon asset and the viewer's page of
``tetsim_tpu/`` by path.
"""
from .params import PhysicsParams, default_cpu_params, default_gpu_params
from .state import SimState, Controls, init_state
from .mesh import (TetMesh, TetArrays, load_dragon, grid_mesh, build_arrays,
                   masked_grid_mesh, ellipsoid_mesh, with_boundary_surface,
                   replicate_mesh, load_npz, save_npz, load_tetgen)
from .solvers import get_engine
from . import parallel  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "PhysicsParams",
    "default_cpu_params",
    "default_gpu_params",
    "SimState",
    "Controls",
    "init_state",
    "TetMesh",
    "TetArrays",
    "load_dragon",
    "grid_mesh",
    "masked_grid_mesh",
    "ellipsoid_mesh",
    "with_boundary_surface",
    "build_arrays",
    "replicate_mesh",
    "load_npz",
    "save_npz",
    "load_tetgen",
    "get_engine",
    "parallel",
    "World",
]


def __getattr__(name):
    if name == "World":
        from .world import World

        return World
    raise AttributeError(name)
