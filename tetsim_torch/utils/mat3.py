"""Batched 3x3 matrix helpers (counterpart of ``tetsim_tpu/utils/mat3.py``).

Every contraction is an elementwise multiply + sum, in exact f32.

Convention: column-major mat3 as in the reference, ``m[..., r, c]`` —
columns are vectors (edge matrices store edges as columns).
"""
from __future__ import annotations

import torch


def matmul(a, b):
    """c[...,i,j] = sum_k a[...,i,k] * b[...,k,j]."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def matmul_t(a, b):
    """a @ b^T: c[...,i,j] = sum_k a[...,i,k] * b[...,j,k]."""
    return (a[..., :, None, :] * b[..., None, :, :]).sum(dim=-1)


def cross(a, b):
    """Cross product over the last axis (size 3)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def det(m):
    """Determinant via first-column cofactor."""
    return (m[..., 0] * cross(m[..., 1], m[..., 2])).sum(dim=-1)


def outer_sum(a, b):
    """c[...,r,c] = sum_k a[...,k,r] * b[...,k,c] over the point axis k
    (the covariance of two point sets), added one point at a time in k
    order, as the polar frame kernel adds them."""
    out = a[..., 0, :, None] * b[..., 0, None, :]
    for k in range(1, a.shape[-2]):
        out = out + a[..., k, :, None] * b[..., k, None, :]
    return out


def cofactor_columns(m):
    """[col1 x col2 | col2 x col0 | col0 x col1]."""
    c0, c1, c2 = m[..., 0], m[..., 1], m[..., 2]
    return torch.stack([cross(c1, c2), cross(c2, c0), cross(c0, c1)], dim=-1)
