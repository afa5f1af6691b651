"""Halo updates — the paper's ``update_halo!`` on virtual ranks.

A field is a tensor ``(*lead, *dims, *local)``: the block axes come first
and every block holds its local array, halo cells included.  For each
distributed grid dimension, every block sends its innermost non-halo slabs
``[h, 2h)`` and ``[n-2h, n-h)`` to its two neighbours.  On one card that
exchange is a copy between neighbouring blocks of the same tensor, done by
:func:`exchange`; a multi-card backend replaces that one function.

Non-periodic physical boundaries keep their existing ring (it holds the
boundary conditions).  Dimensions are updated in sequence, so corner and
edge values propagate across dimensions as in ImplicitGlobalGrid.

Unlike the reference, which returns new arrays, the update writes the halo
planes of the given tensors in place (no second copy of the field) and
returns the same tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..telemetry.counters import record_halo as _record_halo
from .locations import STAGGER_DIM
from .topology import CartesianTopology

# Bare arrays (location None) exchange like centers.
_STAGGER_DIM = {None: None, **STAGGER_DIM}


def exchange(slab: torch.Tensor, block_axis: int, shift: int) -> torch.Tensor:
    """Neighbour exchange along one block axis: block ``b`` of the result
    holds what block ``b - shift`` sent (wrapping at the ends).

    This is the virtual-ranks backend: every block lives on this card, so a
    send is a copy between blocks.  The result is a fresh tensor, so reading
    it never races with writes into the field it came from.
    """
    return torch.roll(slab, shift, block_axis)


def _update_one_dim(topo: CartesianTopology, A: torch.Tensor, gdim: int,
                    block_axis: int, axis: int, h: int) -> None:
    """Halo-update local axis ``axis`` (grid dimension ``gdim``) in place."""
    n = A.shape[axis]
    if 2 * h >= n:
        raise ValueError(f"halo width {h} too large for local extent {n}")
    D = A.shape[block_axis]
    send_low = A.narrow(axis, h, h)            # -> left neighbour's high halo
    send_high = A.narrow(axis, n - 2 * h, h)   # -> right neighbour's low halo
    recv_low = exchange(send_high, block_axis, +1)
    recv_high = exchange(send_low, block_axis, -1)
    low = A.narrow(axis, 0, h)
    high = A.narrow(axis, n - h, h)
    if topo.periodic[gdim]:
        low.copy_(recv_low)
        high.copy_(recv_high)
    elif D > 1:
        # Physical-boundary blocks keep their ring (it holds the BCs).
        low.narrow(block_axis, 1, D - 1).copy_(recv_low.narrow(block_axis, 1, D - 1))
        high.narrow(block_axis, 0, D - 1).copy_(recv_high.narrow(block_axis, 0, D - 1))


def update_halo(
    topo: CartesianTopology,
    *arrays: torch.Tensor,
    width: int = 1,
    dims: Sequence[int] | None = None,
    locations: Sequence[str | None] | None = None,
):
    """Exchange halos of ``arrays`` in place; returns them (one tensor if one
    was passed).

    Each array is ``(*lead, *topo.dims, *local)``.  ``width`` is the halo
    width h (the paper's ``overlap = 2h``); ``dims`` restricts the update to
    some grid dimensions; ``locations`` gives each array's staggering
    location (the exchange is location-independent; unknown names raise).
    """
    nd = topo.ndims
    dims = tuple(dims) if dims is not None else tuple(range(nd))
    if locations is not None and len(locations) != len(arrays):
        raise ValueError(
            f"got {len(locations)} locations for {len(arrays)} arrays")
    for loc in locations or ():
        if loc not in _STAGGER_DIM:
            raise ValueError(f"unknown staggering location {loc!r}")
    for A in arrays:
        off = A.ndim - 2 * nd
        if off < 0 or tuple(A.shape[off:off + nd]) != tuple(topo.dims):
            raise ValueError(
                f"array of shape {tuple(A.shape)} is not a field over blocks "
                f"{tuple(topo.dims)}: expected (*lead, *dims, *local)")
        for d in dims:
            if topo.dims[d] == 1 and not topo.periodic[d]:
                continue  # nothing to exchange
            # telemetry hook (one falsy check unless a collector is active):
            # ONE block's slab, (*lead, *local), as a rank sends it
            _record_halo(A.shape[:off] + A.shape[off + nd:], off + d, width,
                         A.element_size())
            _update_one_dim(topo, A, d, off + d, off + nd + d, width)
    return arrays[0] if len(arrays) == 1 else arrays
