"""The yardstick's frozen work counts and the card's published peaks.

The operations and bytes of one frame of the two kernels the cells time,
counted from the shapes.  They copy ``frame_flops`` / ``frame_bytes`` of
``tetsim_torch/kernels/gs_fused.py`` (K1) and ``kernels/nh_stencil.py``
(K3) as they stand when this benchmark was written, so that a later change
to the port cannot move its own roofline;
``portbench/tests/test_portbench_work.py`` holds the copies to the port's
functions.

Operations: 421 a tet and substep (both Neo-Hookean projections and the
volume-error sum; adds, multiplies, divides and square roots, not compares
or selects), 13 a particle and substep (predict and the velocity update).
Bytes: each input read once and each output written once, as the port's
functions count them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # HBM3 bandwidth

FLOPS_PER_TET = 421
FLOPS_PER_PARTICLE = 13


def k1_frame_flops(tets: int, particles: int, substeps: int,
                   bodies: int) -> int:
    """One K1 frame (``gs_frame.cu``) of ``bodies`` bodies of one mesh."""
    return bodies * substeps * (FLOPS_PER_TET * tets
                                + FLOPS_PER_PARTICLE * particles)


def k1_frame_bytes(tets: int, particles: int, substeps: int, bodies: int,
                   grabs: int) -> int:
    """pos and vel read, pos, prev and vel written (12 bytes a particle
    each), vol_err and the grabs per body; a tet's slot tables (73 bytes)
    and inv_mass once for the batch."""
    return (bodies * (5 * 12 * particles + 4 * substeps + 16 * grabs)
            + 73 * tets + 4 * particles)


def k3_frame_flops(dims, substeps: int, bodies: int) -> int:
    """One K3 frame (``nh_stencil.cu``) of ``bodies`` boxes of ``dims``
    cubes."""
    nx, ny, nz = dims
    tets = 6 * nx * ny * nz
    particles = (nx + 1) * (ny + 1) * (nz + 1)
    return bodies * substeps * (FLOPS_PER_TET * tets
                                + FLOPS_PER_PARTICLE * particles)


def k3_frame_bytes(dims, substeps: int, bodies: int, grabs: int) -> int:
    """pos and vel read, pos, prev and vel written, vol_err and the grabs
    per box; inv_mass once."""
    nx, ny, nz = dims
    particles = (nx + 1) * (ny + 1) * (nz + 1)
    return (bodies * (5 * 12 * particles + 4 * substeps + 16 * grabs)
            + 4 * particles)


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the operations at
    the FP32 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
