"""Location-generic multigrid grid-transfer operators.

One restriction/prolongation pair per staggering location, built from
separable per-dim passes.  Under the 2:1 coarsening of
:meth:`ImplicitGlobalGrid.coarsen`:

* along a center dim (any dim of a center field, a non-staggered dim of a
  face field) coarse cell ``i`` has fine children ``2i - 1, 2i``, so
  restriction is the cell-centered full weighting ``[1/8, 3/8, 3/8, 1/8]``
  and prolongation the linear ``3/4``/``1/4`` split;
* along the staggered dim of a face field coarse face ``i`` lands exactly
  on fine face ``2i``, so restriction is the vertex full weighting
  ``[1/4, 1/2, 1/4]`` over ``{2i-1, 2i, 2i+1}`` and prolongation copies at
  coincident faces and averages in between.

Both pairs satisfy ``P = 2 R^T`` per dim (``P = 2**nd R^T`` overall),
which keeps the V-cycle a symmetric preconditioner for CG at every
location.  The fine points a transfer reads always lie in the local fine
block plus its one-cell halo, so every transfer is block-local and needs
one ``update_halo`` on its result.

Fields are ``(..., *local)``: the transfers act on the trailing ``nd``
axes and take and return arrays with a zero ring; callers mask face
results to the location's unknowns.
"""

from __future__ import annotations

import torch

from ..core.locations import stagger_dim


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


def _restrict_face_1d(a, nd: int, d: int):
    """Vertex full weighting [1/4, 1/2, 1/4] along the staggered ``d``:
    coarse face ``i`` coincides with fine face ``2i``."""
    nf = a.shape[a.ndim - nd + d]
    return (0.25 * a[_sd(nd, d, 1, nf - 2, 2)]
            + 0.50 * a[_sd(nd, d, 2, nf - 1, 2)]
            + 0.25 * a[_sd(nd, d, 3, nf, 2)])


def restrict(fine, loc: str = "center", nd: int = 3):
    """Fine residual -> coarse rhs for a field at ``loc``.

    ``fine`` must be halo-consistent with zeros outside its unknowns.  The
    result has the coarse local shape with a zero ring; mask it to the
    coarse location's unknowns and ``update_halo`` it before use.
    """
    sd = stagger_dim(loc)
    a = fine
    for d in range(nd):
        a = _restrict_face_1d(a, nd, d) if d == sd else _restrict_center_1d(a, nd, d)
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


def _prolong_face_1d(a, nd: int, d: int):
    """Vertex linear interpolation along the staggered ``d``: fine face
    ``2i`` copies coarse face ``i``, fine face ``2i + 1`` averages coarse
    faces ``i`` and ``i + 1``.  The output covers the fine interior
    ``1 .. n_f - 2``: face ``1`` averages coarse faces ``0`` and ``1``, and
    the trailing slot ``n_f - 1`` is dropped (halo or dead plane)."""
    ax = a.ndim - nd + d
    nc = a.shape[ax]
    mid = a[_sd(nd, d, 1, nc - 1)]                       # c[i], i = 1..nc-2
    odd = 0.5 * (mid + a[_sd(nd, d, 2, nc)])             # fine 2i+1
    pair = torch.stack([mid, odd], dim=ax + 1)           # fine 2..n_f-1
    shape = list(pair.shape)
    shape[ax:ax + 2] = [2 * (nc - 2)]
    pair = pair.reshape(shape)
    first = 0.5 * (a[_sd(nd, d, 0, 1)] + a[_sd(nd, d, 1, 2)])   # fine 1
    return torch.cat([first, pair.narrow(ax, 0, shape[ax] - 1)], dim=ax)


def prolong(coarse, loc: str = "center", nd: int = 3):
    """Coarse correction -> fine grid for a field at ``loc``.

    ``coarse`` must be halo-consistent with zeros outside its unknowns.
    The result has a zero ring; mask it to the fine location's unknowns and
    ``update_halo`` it before use.
    """
    sd = stagger_dim(loc)
    a = coarse
    for d in range(nd):
        a = _prolong_face_1d(a, nd, d) if d == sd else _prolong_center_1d(a, nd, d)
    return _pad(a, nd)


def coarsen_coefficient(c, nd: int = 3):
    """Center coefficient field -> coarse level (full-weighted average).

    The physical ring is edge-replicated (nearest interior value); halo
    cells need a subsequent ``update_halo``.  Face-located cycles derive
    their own-dim and edge-averaged coefficients from this same center
    hierarchy.
    """
    a = c
    for d in range(nd):
        a = _restrict_center_1d(a, nd, d)
    return _pad(a, nd, edge=True)
