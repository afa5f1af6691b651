"""Cartesian topology of blocks, spread over the processes of a group.

The reference builds a Cartesian device mesh (one device per rank, the
paper's ``MPI_Cart_create``).  Here every rank is a *block* of a field
tensor: ``dims`` are the global block counts per grid dimension, and the
blocks are spread over ``prod(procs)`` processes of a ``torch.distributed``
group, each process holding the contiguous box of ``local_dims[d] =
dims[d] // procs[d]`` blocks per dimension that starts at block
``offset[d]``.  A process's field tensor is ``(*local_dims, *local_shape)``:
its blocks are virtual ranks on its device.  ``procs = (1, ..., 1)`` (no
group, or a group of one process) is one process holding every block.

Rank coordinates are global: the coordinate of a block is its index along
the block axis plus the process's offset, so the rank tests
``is_first``/``is_last`` (per-block boolean tensors that broadcast against
a field) and every mask built on them see the block's place in the whole
grid.  Processes are numbered row-major over ``procs``, and blocks
row-major over ``dims`` (the reference's device order).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch


def dims_create(nprocs: int, ndims: int) -> tuple[int, ...]:
    """Factor ``nprocs`` into ``ndims`` near-equal factors (MPI_Dims_create).

    Returns dims sorted descending (largest first), matching MPI semantics.
    """
    if nprocs <= 0:
        raise ValueError(f"nprocs must be positive, got {nprocs}")
    dims = [1] * ndims
    primes = []
    n = nprocs
    f = 2
    while f * f <= n:
        while n % f == 0:
            primes.append(f)
            n //= f
        f += 1
    if n > 1:
        primes.append(n)
    # Greedy: the largest prime factor goes to the smallest dim (first on ties).
    for p in sorted(primes, reverse=True):
        i = dims.index(min(dims))
        dims[i] *= p
    return tuple(sorted(dims, reverse=True))


def procs_for(dims, nprocs: int) -> tuple[int, ...]:
    """The default process layout of ``nprocs`` processes over the global
    block counts ``dims``: of the Cartesian factorisations ``procs`` of
    ``nprocs`` with ``dims[d] % procs[d] == 0``, the one whose largest
    per-process block count is least, ties going to the larger factor
    first (``dims_create``'s order).  Raises if none divides ``dims``."""
    dims = tuple(int(d) for d in dims)
    cands = [p for p in itertools.product(*(range(1, d + 1) for d in dims))
             if math.prod(p) == nprocs and all(d % q == 0 for d, q in zip(dims, p))]
    if not cands:
        raise ValueError(
            f"dims {dims} cannot be split evenly over {nprocs} processes: every "
            f"dims[d] must be a multiple of procs[d], with prod(procs) == {nprocs}")
    return min(cands, key=lambda p: (max(d // q for d, q in zip(dims, p)),
                                     tuple(-q for q in p)))


@dataclasses.dataclass(frozen=True)
class CartesianTopology:
    """Global block counts ``dims[d]``, wraparound flags ``periodic[d]``,
    the process layout ``procs[d]`` and this process's coordinate
    ``pcoord[d]`` in it (default: one process holding every block)."""

    dims: tuple[int, ...]
    periodic: tuple[bool, ...]
    procs: tuple[int, ...] | None = None
    pcoord: tuple[int, ...] | None = None

    def __post_init__(self):
        if len(self.dims) != len(self.periodic):
            raise ValueError("dims and periodic must have the same length")
        if any(int(d) < 1 for d in self.dims):
            raise ValueError(f"dims must be positive, got {self.dims}")
        nd = len(self.dims)
        procs = (1,) * nd if self.procs is None else tuple(int(p) for p in self.procs)
        pcoord = (0,) * nd if self.pcoord is None else tuple(int(c) for c in self.pcoord)
        if len(procs) != nd or len(pcoord) != nd:
            raise ValueError(f"procs {procs} and pcoord {pcoord} must have {nd} entries")
        if any(p < 1 or d % p for d, p in zip(self.dims, procs)):
            raise ValueError(
                f"process layout {procs} does not divide the block counts {tuple(self.dims)}: "
                "every dims[d] must be a multiple of procs[d]")
        if any(not 0 <= c < p for c, p in zip(pcoord, procs)):
            raise ValueError(f"process coordinate {pcoord} lies outside the layout {procs}")
        object.__setattr__(self, "procs", procs)
        object.__setattr__(self, "pcoord", pcoord)

    @property
    def ndims(self) -> int:
        return len(self.dims)

    @property
    def nprocs(self) -> int:
        """Processes the blocks are spread over."""
        return math.prod(self.procs)

    @property
    def local_dims(self) -> tuple[int, ...]:
        """Blocks per dimension that this process holds."""
        return tuple(d // p for d, p in zip(self.dims, self.procs))

    @property
    def offset(self) -> tuple[int, ...]:
        """Global coordinate of this process's first block."""
        return tuple(c * n for c, n in zip(self.pcoord, self.local_dims))

    def process_rank(self, pcoord) -> int:
        """Group rank of the process at ``pcoord`` (row-major over ``procs``)."""
        return int(np.ravel_multi_index(tuple(pcoord), self.procs))

    def neighbour(self, dim: int, shift: int) -> int | None:
        """Group rank of the process ``shift`` (+-1) away along ``dim``
        (wrapping on a periodic dim), None past a physical boundary."""
        c = list(self.pcoord)
        c[dim] += shift
        if not 0 <= c[dim] < self.procs[dim]:
            if not self.periodic[dim]:
                return None
            c[dim] %= self.procs[dim]
        return self.process_rank(c)

    def block_ranks(self) -> list[int]:
        """Global ranks of this process's blocks (row-major over ``dims``),
        in the order of its block axes."""
        return [int(np.ravel_multi_index(tuple(o + i for o, i in zip(self.offset, idx)),
                                         self.dims))
                for idx in np.ndindex(*self.local_dims)]

    def shift_perm(self, dim: int, shift: int) -> list[tuple[int, int]]:
        """(source, dest) pairs moving data ``shift`` ranks along ``dim``."""
        n = self.dims[dim]
        pairs = []
        for src in range(n):
            dst = src + shift
            if self.periodic[dim]:
                pairs.append((src, dst % n))
            elif 0 <= dst < n:
                pairs.append((src, dst))
        return pairs

    def coord(self, dim: int, device=None) -> torch.Tensor:
        """Global rank coordinate along ``dim`` of every block of this
        process, shaped ``(1, .., local_dims[dim], .., 1)`` over the block
        axes followed by ``ndims`` singleton local axes, so it broadcasts
        against a field."""
        shape = [1] * (2 * self.ndims)
        n = self.local_dims[dim]
        shape[dim] = n
        return (torch.arange(n, device=device) + self.offset[dim]).reshape(shape)

    def is_first(self, dim: int, device=None) -> torch.Tensor:
        return self.coord(dim, device) == 0

    def is_last(self, dim: int, device=None) -> torch.Tensor:
        return self.coord(dim, device) == self.dims[dim] - 1
