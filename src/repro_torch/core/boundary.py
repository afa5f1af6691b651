"""Physical boundary conditions on fields of virtual ranks.

A non-periodic halo update leaves the outermost planes of the
physical-boundary blocks untouched; these helpers set them.  A field is
``(*lead, *dims, *local)``: ``dim`` is a grid dimension, acting on its
local axis, and each block is masked by its own rank coordinate, so inner
blocks keep their planes.

Location-awareness (shape-uniform staggering of :mod:`repro_torch.fields`):
for a field staggered ALONG ``dim`` the physical boundary faces are the
global first face ``0`` and last valid face ``N - 2``, i.e. local planes
``[0, w)`` on the first block and ``[n - 1 - w, n - 1)`` on the last, with
the dead plane ``n - 1`` zeroed.  Pass ``staggered=True`` for that.

Like the reference, both functions return a new tensor and leave ``A`` as
it was.
"""

from __future__ import annotations

import torch

from .topology import CartesianTopology


def _set_lo_hi(topo: CartesianTopology, A, dim: int, lo_dst, hi_dst, lo_val, hi_val):
    ax = A.ndim - topo.ndims + dim
    lo = A.narrow(ax, lo_dst[0], lo_dst[1] - lo_dst[0])
    hi = A.narrow(ax, hi_dst[0], hi_dst[1] - hi_dst[0])
    lo_new = torch.where(topo.is_first(dim, A.device), lo_val, lo)
    hi_new = torch.where(topo.is_last(dim, A.device), hi_val, hi)
    A = A.clone()
    A.narrow(ax, lo_dst[0], lo_dst[1] - lo_dst[0]).copy_(lo_new)
    A.narrow(ax, hi_dst[0], hi_dst[1] - hi_dst[0]).copy_(hi_new)
    return A


def _zero_dead_plane(topo: CartesianTopology, A, dim: int):
    """Zero the staggered dead plane (the last block's trailing face slot)."""
    ax = A.ndim - topo.ndims + dim
    dead = A.narrow(ax, A.shape[ax] - 1, 1)
    dead.copy_(torch.where(topo.is_last(dim, A.device), torch.zeros_like(dead), dead))
    return A


def dirichlet(topo: CartesianTopology, A, value, dim: int, width: int = 1,
              staggered: bool = False):
    """Set the physical low/high boundary planes along ``dim`` to ``value``.

    ``staggered=True``: ``A`` is face-staggered along ``dim``; the value
    lands on the boundary faces ``[0, w)`` / ``[N-1-w, N-1)`` and the dead
    plane is zeroed.
    """
    n = A.shape[A.ndim - topo.ndims + dim]
    hi_end = n - 1 if staggered else n
    lo_dst, hi_dst = (0, width), (hi_end - width, hi_end)
    ax = A.ndim - topo.ndims + dim
    full = torch.full_like(A.narrow(ax, 0, width), value)
    A = _set_lo_hi(topo, A, dim, lo_dst, hi_dst, full, full)
    if staggered:
        A = _zero_dead_plane(topo, A, dim)
    return A


def neumann0(topo: CartesianTopology, A, dim: int, width: int = 1, staggered: bool = False):
    """Zero flux: copy the first interior plane into the boundary planes."""
    ax = A.ndim - topo.ndims + dim
    n = A.shape[ax]
    hi_end = n - 1 if staggered else n
    lo_dst, hi_dst = (0, width), (hi_end - width, hi_end)
    lo_src = A.narrow(ax, width, 1)
    hi_src = A.narrow(ax, hi_end - width - 1, 1)
    A = _set_lo_hi(topo, A, dim, lo_dst, hi_dst, lo_src, hi_src)
    if staggered:
        A = _zero_dead_plane(topo, A, dim)
    return A
