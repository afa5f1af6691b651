"""Multigrid grid-transfer operators for cell-centered fields.

Under the 2:1 coarsening of :meth:`ImplicitGlobalGrid.coarsen`, coarse
cell ``i`` has fine children ``2i - 1, 2i`` (the coarse cell center falls
midway between them), so restriction is the cell-centered full weighting
``[1/8, 3/8, 3/8, 1/8]`` over children and outer neighbours, and
prolongation the (tri)linear ``3/4``/``1/4`` split — separable passes per
dim, with ``P = 2**nd R^T`` (what keeps the V-cycle a symmetric
preconditioner for CG).  The children of owned coarse points always lie in
the local fine block plus its one-cell halo, so every transfer is
block-local and needs one ``update_halo`` on its result.

Fields are ``(..., *local)``: the transfers act on the trailing ``nd``
axes and take and return arrays with a zero ring.  The face-located
transfers come with the staggered slice of the port.
"""

from __future__ import annotations

import torch

from ..kernels.solver3d.ref import center_only


def _sd(nd: int, d: int, start, stop, step=None) -> tuple:
    """Slice local dim ``d`` of the trailing ``nd``; the rest stay full."""
    s: list = [slice(None)] * nd
    s[d] = slice(start, stop, step)
    return (Ellipsis, *s)


def _pad(a, nd: int, edge: bool = False):
    """Pad the trailing ``nd`` axes by one cell: zeros, or the edge value."""
    for d in range(nd):
        ax = a.ndim - nd + d
        if edge:
            lo, hi = a.narrow(ax, 0, 1), a.narrow(ax, a.shape[ax] - 1, 1)
        else:
            shape = list(a.shape)
            shape[ax] = 1
            lo = hi = a.new_zeros(shape)
        a = torch.cat([lo, a, hi], dim=ax)
    return a


def _restrict_center_1d(a, nd: int, d: int):
    """Cell-centered full weighting [1/8, 3/8, 3/8, 1/8] along ``d``."""
    nf = a.shape[a.ndim - nd + d]
    return (0.125 * a[_sd(nd, d, 0, nf - 3, 2)]
            + 0.375 * a[_sd(nd, d, 1, nf - 2, 2)]
            + 0.375 * a[_sd(nd, d, 2, nf - 1, 2)]
            + 0.125 * a[_sd(nd, d, 3, nf, 2)])


def restrict(fine, loc: str = "center", nd: int = 3):
    """Fine residual -> coarse rhs.

    ``fine`` must be halo-consistent with zeros outside its unknowns.  The
    result has the coarse local shape with a zero ring; ``update_halo`` it
    before use.
    """
    center_only(loc, "transfers.restrict")
    a = fine
    for d in range(nd):
        a = _restrict_center_1d(a, nd, d)
    return _pad(a, nd)


def _prolong_center_1d(a, nd: int, d: int):
    """Cell-centered linear interpolation along ``d`` (3/4, 1/4 pairs)."""
    ax = a.ndim - nd + d
    nc = a.shape[ax]
    mid = a[_sd(nd, d, 1, nc - 1)]
    lower = 0.75 * mid + 0.25 * a[_sd(nd, d, 0, nc - 2)]
    upper = 0.75 * mid + 0.25 * a[_sd(nd, d, 2, nc)]
    pair = torch.stack([lower, upper], dim=ax + 1)
    shape = list(pair.shape)
    shape[ax:ax + 2] = [2 * (nc - 2)]
    return pair.reshape(shape)


def prolong(coarse, loc: str = "center", nd: int = 3):
    """Coarse correction -> fine grid.

    ``coarse`` must be halo-consistent with zeros outside its unknowns.
    The result has a zero ring; ``update_halo`` it before use.
    """
    center_only(loc, "transfers.prolong")
    a = coarse
    for d in range(nd):
        a = _prolong_center_1d(a, nd, d)
    return _pad(a, nd)


def coarsen_coefficient(c, nd: int = 3):
    """Center coefficient field -> coarse level (full-weighted average).

    The physical ring is edge-replicated (nearest interior value); halo
    cells need a subsequent ``update_halo``.
    """
    a = c
    for d in range(nd):
        a = _restrict_center_1d(a, nd, d)
    return _pad(a, nd, edge=True)
