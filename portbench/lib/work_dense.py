"""The frozen work counts of the dense frame kernel (``dense_frame_kernel``,
``tetsim_torch/kernels/csrc/dense_frame.cu``), counted from the shapes.

They copy ``frame_flops`` / ``frame_bytes`` of
``tetsim_torch/kernels/dense_frame.py`` as they stand when the
``dragon_nh_ordered`` configuration was added, at the configuration's
shapes, so that a later change to the port cannot move its own roofline;
``portbench/tests/test_portbench_dense_ordered.py`` holds the copies to the
port's functions.

Operations: 421 a tet and substep (both Neo-Hookean projections), 13 a
particle and substep (predict and the velocity update), as ``work.py``
counts them.  Bytes: pos and vel read once and pos, prev and vel written
once (12 bytes a particle each), a grab read per body (id and target), and
the level tables' valid slots read once (the kernel skips the padded
ones): a tet's four corner ids (int32), inverse rest pose (9 f32), inverse
rest volume (f32) and corners' inverse masses (4 f32), 72 bytes a tet.
"""
from __future__ import annotations

from portbench.lib import work

TABLE_BYTES_PER_TET = 4 * 4 + 9 * 4 + 4 + 4 * 4


def frame_flops(tets: int, particles: int, substeps: int,
                bodies: int) -> int:
    """One frame of ``bodies`` bodies of one mesh."""
    return bodies * substeps * (work.FLOPS_PER_TET * tets
                                + work.FLOPS_PER_PARTICLE * particles)


def frame_bytes(particles: int, tets: int, bodies: int) -> int:
    """The bodies' state and grabs, and the tets' table rows once."""
    return (bodies * (5 * 12 * particles + 16)
            + TABLE_BYTES_PER_TET * tets)


def bound_s(run) -> float:
    """The least time of one frame of the run's batch."""
    c = run.cell.config
    return work.bound_s(
        frame_flops(c["tets"], c["particles"], run.substeps, run.bodies),
        frame_bytes(c["particles"], c["tets"], run.bodies))
