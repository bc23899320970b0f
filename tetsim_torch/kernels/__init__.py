"""Hand-written CUDA kernels of the port, each beside its plain-torch twin.

  gs_fused      — the fused coloured Gauss-Seidel frame (csrc/gs_frame.cu)
  polar_fused   — the fused polar shape-matching frame (csrc/polar_frame.cu)
  polar_stencil — the polar grid stencil substep (csrc/polar_stencil.cu)
  nh_stencil    — the Neo-Hookean 48-colour grid sweep (csrc/nh_stencil.cu)
  polar_pieces  — the polar solve on the pieces of one mesh (csrc/polar_pieces.cu)
  nh_pieces     — the Neo-Hookean pieces frame: the per-piece sweep and the
                  substep around it, one launch per frame (csrc/nh_pieces.cu)
  gs_ordered    — the exact-order Gauss-Seidel frame (csrc/gs_ordered.cu)
  gs_levels     — the Neo-Hookean frame of a body too large for one block,
                  one launch per frame on a thread-block cluster per body
                  (csrc/gs_levels.cu)
  polar_jacobi  — the polar frame of a body too large for one block, one
                  cooperative launch per frame (csrc/polar_jacobi.cu)
  dense_frame   — the frame of the dense Neo-Hookean engine
                  (solvers/dense.py): each level gathered and scattered
                  by index, one launch per frame, a block per body with
                  its positions in shared memory or, past 19,370
                  particles, a thread-block cluster per body with its
                  positions in global memory (csrc/dense_frame.cu)

``FusedGSBody`` and ``FusedPolarBody`` split their batch over the devices
of a ``parallel.DeviceMesh`` axis with ``shard``: one launch per device.
polar_stencil and nh_stencil also carry the grid boxes' x-slab forms (K4a:
two launches per substep and card; K3s: one cooperative launch per
frame and card), driven over a ``parallel.SlabMesh``.

(``tetsim_torch/roofline.py`` wraps the extract_rotation micro-kernel,
csrc/extract_rotation.cu.)
"""
from .gs_fused import FusedGSBody  # noqa: F401
