"""Cartesian topology of virtual ranks on one card.

The reference builds a Cartesian device mesh (one device per rank, the
paper's ``MPI_Cart_create``).  Here every rank is a *virtual rank*: a block
of a field tensor ``(*dims, *local_shape)`` on the same card.  A topology is
therefore just the block counts per grid dimension and the periodicity
flags; the rank coordinate of a block is its index along a block axis, and
the rank tests ``is_first``/``is_last`` are per-block boolean tensors that
broadcast against a field.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class CartesianTopology:
    """Block counts ``dims[d]`` and wraparound flags ``periodic[d]``."""

    dims: tuple[int, ...]
    periodic: tuple[bool, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.periodic):
            raise ValueError("dims and periodic must have the same length")
        if any(int(d) < 1 for d in self.dims):
            raise ValueError(f"dims must be positive, got {self.dims}")

    @property
    def ndims(self) -> int:
        return len(self.dims)

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
        """Rank coordinate along ``dim`` of every block, shaped
        ``(1, .., dims[dim], .., 1)`` over the block axes followed by
        ``ndims`` singleton local axes, so it broadcasts against a field."""
        shape = [1] * (2 * self.ndims)
        shape[dim] = self.dims[dim]
        return torch.arange(self.dims[dim], device=device).reshape(shape)

    def is_first(self, dim: int, device=None) -> torch.Tensor:
        return self.coord(dim, device) == 0

    def is_last(self, dim: int, device=None) -> torch.Tensor:
        return self.coord(dim, device) == self.dims[dim] - 1
