"""Staggering locations — the canonical table and the location-aware masks.

A grid array carries a *location*: ``center`` (entry ``i`` at node ``i``)
or ``xface``/``yface``/``zface`` (entry ``i`` along the staggered dim at the
face ``i + 1/2``; the trailing plane is a dead plane).  Under this
shape-uniform convention the halo exchange is location-independent; it only
rejects unknown names.  ``STAGGER_DIM`` maps each location to the grid
dimension it is staggered along.

The mask builders return a field ``(*dims, *local_shape)``: every block
gets the mask of its own rank coordinate.  They take any grid object with
the :class:`repro_torch.core.grid.ImplicitGlobalGrid` interface.
"""

from __future__ import annotations

import torch

LOCATIONS = ("center", "xface", "yface", "zface")
STAGGER_DIM = {"center": None, "xface": 0, "yface": 1, "zface": 2}


def stagger_dim(loc: str) -> int | None:
    """Grid dimension a location is staggered along (None for center)."""
    try:
        return STAGGER_DIM[loc]
    except KeyError:
        raise ValueError(f"unknown location {loc!r}; expected one of {LOCATIONS}") from None


def valid_mask(grid, loc: str, dtype=None) -> torch.Tensor:
    """1.0 on real points of ``loc`` (excludes the staggered dead plane)."""
    dtype = dtype or grid.dtype
    m = grid.ones(dtype)
    sd = stagger_dim(loc)
    if sd is not None:
        gidx = grid.local_global_indices()
        m = m * (gidx[sd] < grid.n_g(sd) - 1).to(dtype)
    return m


def interior_mask(grid, loc: str, dtype=None) -> torch.Tensor:
    """1.0 on the unknowns of a field at ``loc``.

    Along a non-staggered Dirichlet dim the boundary ring is the global
    ``[0, w)`` / ``[N - w, N)``; along a staggered Dirichlet dim the
    boundary faces are ``[0, w)`` and ``[N - 1 - w, N - 1)`` (the dead plane
    ``N - 1`` is excluded too).  ``w`` is the grid halo width.  Periodic
    dims have no pinned planes, so they are left unmasked.
    """
    dtype = dtype or grid.dtype
    w = grid.halo
    m = grid.ones(dtype)
    gidx = grid.local_global_indices()
    sd = stagger_dim(loc)
    for d in range(grid.ndims):
        if grid.topo.periodic[d]:
            continue
        hi = grid.n_g(d) - w - (1 if d == sd else 0)
        m = m * ((gidx[d] >= w) & (gidx[d] < hi)).to(dtype)
    return m
