"""Finite differences on a 3-D regular grid, on the trailing three axes.

PyTorch equivalents of ``ParallelStencil.FiniteDifferences3D``.  Every
helper indexes ``A[..., i, j, k]``, so it acts on one local block
``(nx, ny, nz)``, on a whole field ``(*dims, nx, ny, nz)`` with the block
axes as a batch, and on the slabs carved out by
:func:`repro_torch.core.hide.hide_communication`.  Naming follows the Julia
package: ``_a`` = all points along that dim, ``_i`` = inner points of the
*other* dims, ``inn`` = inner points of all dims.

    d_xa(A)  -> (nx-1, ny,   nz  )
    d_xi(A)  -> (nx-1, ny-2, nz-2)
    d2_xi(A) -> (nx-2, ny-2, nz-2)
    inn(A)   -> (nx-2, ny-2, nz-2)
    av(A)    -> (nx-1, ny-1, nz-1)
"""

from __future__ import annotations

import torch

__all__ = [
    "inn", "inn_x", "inn_y", "inn_z",
    "d_xa", "d_ya", "d_za", "d_xi", "d_yi", "d_zi",
    "d2_xa", "d2_ya", "d2_za", "d2_xi", "d2_yi", "d2_zi",
    "av", "av_xa", "av_ya", "av_za", "av_xi", "av_yi", "av_zi",
    "maxloc",
]


def inn(A):
    return A[..., 1:-1, 1:-1, 1:-1]


def inn_x(A):
    return A[..., 1:-1, :, :]


def inn_y(A):
    return A[..., :, 1:-1, :]


def inn_z(A):
    return A[..., :, :, 1:-1]


# -- first differences ---------------------------------------------------

def d_xa(A):
    return A[..., 1:, :, :] - A[..., :-1, :, :]


def d_ya(A):
    return A[..., :, 1:, :] - A[..., :, :-1, :]


def d_za(A):
    return A[..., :, :, 1:] - A[..., :, :, :-1]


def d_xi(A):
    return A[..., 1:, 1:-1, 1:-1] - A[..., :-1, 1:-1, 1:-1]


def d_yi(A):
    return A[..., 1:-1, 1:, 1:-1] - A[..., 1:-1, :-1, 1:-1]


def d_zi(A):
    return A[..., 1:-1, 1:-1, 1:] - A[..., 1:-1, 1:-1, :-1]


# -- second differences --------------------------------------------------

def d2_xa(A):
    return A[..., 2:, :, :] - 2.0 * A[..., 1:-1, :, :] + A[..., :-2, :, :]


def d2_ya(A):
    return A[..., :, 2:, :] - 2.0 * A[..., :, 1:-1, :] + A[..., :, :-2, :]


def d2_za(A):
    return A[..., :, :, 2:] - 2.0 * A[..., :, :, 1:-1] + A[..., :, :, :-2]


def d2_xi(A):
    return A[..., 2:, 1:-1, 1:-1] - 2.0 * A[..., 1:-1, 1:-1, 1:-1] + A[..., :-2, 1:-1, 1:-1]


def d2_yi(A):
    return A[..., 1:-1, 2:, 1:-1] - 2.0 * A[..., 1:-1, 1:-1, 1:-1] + A[..., 1:-1, :-2, 1:-1]


def d2_zi(A):
    return A[..., 1:-1, 1:-1, 2:] - 2.0 * A[..., 1:-1, 1:-1, 1:-1] + A[..., 1:-1, 1:-1, :-2]


# -- averages ------------------------------------------------------------

def av(A):
    return 0.125 * (
        A[..., :-1, :-1, :-1] + A[..., 1:, :-1, :-1] + A[..., :-1, 1:, :-1]
        + A[..., :-1, :-1, 1:] + A[..., 1:, 1:, :-1] + A[..., 1:, :-1, 1:]
        + A[..., :-1, 1:, 1:] + A[..., 1:, 1:, 1:]
    )


def av_xa(A):
    return 0.5 * (A[..., 1:, :, :] + A[..., :-1, :, :])


def av_ya(A):
    return 0.5 * (A[..., :, 1:, :] + A[..., :, :-1, :])


def av_za(A):
    return 0.5 * (A[..., :, :, 1:] + A[..., :, :, :-1])


def av_xi(A):
    return 0.5 * (A[..., 1:, 1:-1, 1:-1] + A[..., :-1, 1:-1, 1:-1])


def av_yi(A):
    return 0.5 * (A[..., 1:-1, 1:, 1:-1] + A[..., 1:-1, :-1, 1:-1])


def av_zi(A):
    return 0.5 * (A[..., 1:-1, 1:-1, 1:] + A[..., 1:-1, 1:-1, :-1])


def maxloc(A):
    """Local 3x3x3 neighbourhood maximum on inner points."""
    nx, ny, nz = A.shape[-3:]
    m = A[..., 1:-1, 1:-1, 1:-1]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                m = torch.maximum(
                    m, A[..., 1 + dx:nx - 1 + dx, 1 + dy:ny - 1 + dy, 1 + dz:nz - 1 + dz])
    return m
