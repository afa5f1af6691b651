"""Finite differences on a 2-D regular grid, on the trailing two axes.

PyTorch equivalents of ``ParallelStencil.FiniteDifferences2D``, with the
conventions of :mod:`.fd3d`: every helper indexes ``A[..., i, j]``, so it
acts on one local block ``(nx, ny)``, on a whole field ``(*dims, nx, ny)``
with the block axes as a batch, and on the slabs of
:func:`repro_torch.core.hide.hide_communication`.

    d_xa(A)  -> (nx-1, ny  )
    d_xi(A)  -> (nx-1, ny-2)
    d2_xi(A) -> (nx-2, ny-2)
    inn(A)   -> (nx-2, ny-2)
    av(A)    -> (nx-1, ny-1)
"""

from __future__ import annotations

__all__ = [
    "inn", "d_xa", "d_ya", "d_xi", "d_yi",
    "d2_xa", "d2_ya", "d2_xi", "d2_yi",
    "av", "av_xa", "av_ya", "av_xi", "av_yi",
]


def inn(A):
    return A[..., 1:-1, 1:-1]


def d_xa(A):
    return A[..., 1:, :] - A[..., :-1, :]


def d_ya(A):
    return A[..., :, 1:] - A[..., :, :-1]


def d_xi(A):
    return A[..., 1:, 1:-1] - A[..., :-1, 1:-1]


def d_yi(A):
    return A[..., 1:-1, 1:] - A[..., 1:-1, :-1]


def d2_xa(A):
    return A[..., 2:, :] - 2.0 * A[..., 1:-1, :] + A[..., :-2, :]


def d2_ya(A):
    return A[..., :, 2:] - 2.0 * A[..., :, 1:-1] + A[..., :, :-2]


def d2_xi(A):
    return A[..., 2:, 1:-1] - 2.0 * A[..., 1:-1, 1:-1] + A[..., :-2, 1:-1]


def d2_yi(A):
    return A[..., 1:-1, 2:] - 2.0 * A[..., 1:-1, 1:-1] + A[..., 1:-1, :-2]


def av(A):
    return 0.25 * (A[..., :-1, :-1] + A[..., 1:, :-1] + A[..., :-1, 1:] + A[..., 1:, 1:])


def av_xa(A):
    return 0.5 * (A[..., 1:, :] + A[..., :-1, :])


def av_ya(A):
    return 0.5 * (A[..., :, 1:] + A[..., :, :-1])


def av_xi(A):
    return 0.5 * (A[..., 1:, 1:-1] + A[..., :-1, 1:-1])


def av_yi(A):
    return 0.5 * (A[..., 1:-1, 1:] + A[..., 1:-1, :-1])
