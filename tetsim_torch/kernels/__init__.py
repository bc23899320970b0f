"""Hand-written CUDA kernels of the port, each beside its plain-torch twin.

  gs_fused  — the fused coloured Gauss-Seidel frame (csrc/gs_frame.cu)
"""
from .gs_fused import FusedGSBody  # noqa: F401
