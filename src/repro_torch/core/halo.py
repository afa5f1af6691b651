"""Halo updates — the paper's ``update_halo!`` on blocks.

A field is a tensor ``(*lead, *local_dims, *local)``: the block axes of
this process come first and every block holds its local array, halo cells
included.  For each distributed grid dimension, every block sends its
innermost non-halo slabs ``[h, 2h)`` and ``[n-2h, n-h)`` to its two
neighbours (:func:`exchange`).  Between blocks of one process that is a
copy between neighbouring blocks of the same tensor (a roll along the block
axis); the edge blocks of a process that has neighbouring processes along
the dimension take what those sent instead (:func:`repro_torch.core.comm.
sendrecv`).  A dimension held by one process is a pure local roll, periodic
or not.

Non-periodic physical boundaries keep their existing ring (it holds the
boundary conditions): which blocks those are follows from their global
coordinates.  Dimensions are updated in sequence, so corner and edge values
propagate across dimensions (and processes) as in ImplicitGlobalGrid.

Unlike the reference, which returns new arrays, the update writes the halo
planes of the given tensors in place (no second copy of the field) and
returns the same tensors.

Under an analyzer check (:mod:`repro_torch.analysis`) each array's update
is wrapped in ``exchange_in`` / ``exchange_out`` markers and each exchange
records its peer tables; outside a check each is one falsy test.
"""

from __future__ import annotations

from typing import Sequence

import dataclasses

import numpy as np
import torch

from ..analysis import markers as _mk
from ..telemetry.counters import record_halo as _record_halo
from . import comm
from .locations import STAGGER_DIM
from .topology import CartesianTopology

# Bare arrays (location None) exchange like centers.
_STAGGER_DIM = {None: None, **STAGGER_DIM}


def exchange(topo: CartesianTopology, send_low: torch.Tensor, send_high: torch.Tensor,
             gdim: int, block_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour exchange along grid dimension ``gdim``: returns
    ``(recv_low, recv_high)``, where block ``b`` of ``recv_low`` holds what
    the block before it sent high (``send_high``) and block ``b`` of
    ``recv_high`` what the block after it sent low (``send_low``).

    Within this process a send is a copy between blocks (a roll along the
    block axis, wrapping at the ends).  With neighbouring processes along
    ``gdim``, the edge blocks' wrapped entries are overwritten by the slabs
    those processes sent.  The results are fresh tensors, so reading them
    never races with writes into the field they came from.
    """
    if _mk.TRACE is not None:
        _mk.TRACE.table(**peer_table(topo, gdim, +1), site="core.halo.exchange")
        _mk.TRACE.table(**peer_table(topo, gdim, -1), site="core.halo.exchange")
    recv_low = torch.roll(send_high, 1, block_axis)
    recv_high = torch.roll(send_low, -1, block_axis)
    if topo.procs[gdim] > 1:
        D = send_low.shape[block_axis]
        low, high = topo.neighbour(gdim, -1), topo.neighbour(gdim, +1)
        from_low, from_high = comm.sendrecv(
            send_low.narrow(block_axis, 0, 1), send_high.narrow(block_axis, D - 1, 1),
            low, high)
        if from_low is not None:
            recv_low.narrow(block_axis, 0, 1).copy_(from_low)
        if from_high is not None:
            recv_high.narrow(block_axis, D - 1, 1).copy_(from_high)
    return recv_low, recv_high


def peer_table(topo: CartesianTopology, gdim: int, shift: int) -> dict:
    """The (source block, destination block) pairs along ``gdim`` (global
    block coordinates) of the slabs :func:`exchange` moves ``shift`` (+1:
    each block's high slab to the next block's low halo) and the pairs the
    destinations receive from, for every process coordinate along
    ``gdim``: the roll within a process, :meth:`CartesianTopology.
    neighbour` between processes, and no pair into a physical boundary's
    ring.  The analyzer's congruence rule classifies them."""
    L, P, n = topo.local_dims[gdim], topo.procs[gdim], topo.dims[gdim]
    periodic = topo.periodic[gdim]

    def at(q):
        c = list(topo.pcoord)
        c[gdim] = q
        return dataclasses.replace(topo, pcoord=tuple(c))

    def pcoord_of(rank):
        return int(np.unravel_index(rank, topo.procs)[gdim])

    def partner(q, i, s):
        """Global block next to local block ``i`` of process ``q`` in
        direction ``s``, by the exchange's rule (None: no partner)."""
        j = i + s
        if 0 <= j < L:
            return q * L + j
        if P > 1:
            r = at(q).neighbour(gdim, s)
            return None if r is None else pcoord_of(r) * L + (j % L)
        return q * L + (j % L)

    def takes(c):   # a physical boundary's ring keeps its BCs
        return periodic or not (c == 0 and shift > 0 or c == n - 1 and shift < 0)

    send, recv = [], []
    for q in range(P):
        for i in range(L):
            c = q * L + i
            d = partner(q, i, shift)
            if d is not None and takes(d):
                send.append((c, d))
            s = partner(q, i, -shift)
            if s is not None and takes(c):
                recv.append((s, c))
    return dict(gdim=gdim, shift=shift, n=n, send=send, recv=recv)


def _update_one_dim(topo: CartesianTopology, A: torch.Tensor, gdim: int,
                    block_axis: int, axis: int, h: int) -> None:
    """Halo-update local axis ``axis`` (grid dimension ``gdim``) in place."""
    n = A.shape[axis]
    if 2 * h >= n:
        raise ValueError(f"halo width {h} too large for local extent {n}")
    D = A.shape[block_axis]
    send_low = A.narrow(axis, h, h)            # -> left neighbour's high halo
    send_high = A.narrow(axis, n - 2 * h, h)   # -> right neighbour's low halo
    recv_low, recv_high = exchange(topo, send_low, send_high, gdim, block_axis)
    low = A.narrow(axis, 0, h)
    high = A.narrow(axis, n - h, h)
    if topo.periodic[gdim]:
        low.copy_(recv_low)
        high.copy_(recv_high)
        return
    # Physical-boundary blocks keep their ring (it holds the BCs): the
    # global first block its low ring, the global last block its high one.
    first = 1 if topo.offset[gdim] == 0 else 0
    stop = D - 1 if topo.offset[gdim] + D == topo.dims[gdim] else D
    if D - first > 0:
        low.narrow(block_axis, first, D - first).copy_(
            recv_low.narrow(block_axis, first, D - first))
    if stop > 0:
        high.narrow(block_axis, 0, stop).copy_(recv_high.narrow(block_axis, 0, stop))


def update_halo(
    topo: CartesianTopology,
    *arrays: torch.Tensor,
    width: int = 1,
    dims: Sequence[int] | None = None,
    locations: Sequence[str | None] | None = None,
):
    """Exchange halos of ``arrays`` in place; returns them (one tensor if one
    was passed).

    Each array is ``(*lead, *topo.local_dims, *local)``.  ``width`` is the halo
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
        if off < 0 or tuple(A.shape[off:off + nd]) != tuple(topo.local_dims):
            raise ValueError(
                f"array of shape {tuple(A.shape)} is not a field over blocks "
                f"{tuple(topo.local_dims)}: expected (*lead, *local_dims, *local)")
        _mk.exchange_in(A, width=width, site="core.halo.update_halo")
        for d in dims:
            if topo.dims[d] == 1 and not topo.periodic[d]:
                continue  # nothing to exchange
            # telemetry hook (one falsy check unless a collector is active):
            # ONE block's slab, (*lead, *local), as a rank sends it, so the
            # counts do not depend on how many blocks a process holds
            _record_halo(A.shape[:off] + A.shape[off + nd:], off + d, width,
                         A.element_size())
            _update_one_dim(topo, A, d, off + d, off + nd + d, width)
        _mk.exchange_out(A, width=width, site="core.halo.update_halo")
    return arrays[0] if len(arrays) == 1 else arrays
