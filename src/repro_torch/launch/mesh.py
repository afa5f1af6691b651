"""Process meshes: the processes of the default ``torch.distributed`` group
laid out on named axes.

The port's twin of the JAX package's ``launch/mesh.py``.  Where the
reference lays devices on a ``jax.sharding.Mesh``, the port lays processes
(one a card, or several sharing one card under gloo): rank ``r`` sits at
the coordinates ``r`` has in row-major order over the mesh's shape, as
``jax.make_mesh`` orders devices.  A mesh whose size is not the group's
(1 without a group) raises, so :func:`make_production_mesh` raises on one
card.

A :class:`Mesh` makes, when it is built, one process subgroup for each
non-empty set of its axes (``new_group`` is collective: every process
builds the same meshes in the same order), and :meth:`Mesh.group` returns
this process's :class:`repro_torch.core.comm.Subgroup` for an axis or a
tuple of axes, members in the order of their index along the axes (the
first axis major), as a ``PartitionSpec`` entry orders them.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..core import comm
from ..distributed.sharding import AbstractMesh, entry_axes


class Mesh(AbstractMesh):
    """``shape`` over ``axis_names``: the processes of the default group."""

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        world = comm.world_size()
        if self.size != world:
            raise ValueError(f"a mesh of {dict(self.shape)} holds {self.size} processes; the "
                             f"group has {world}")
        self._dims = tuple(self.shape[a] for a in self.axis_names)
        self._ranks = np.arange(self.size).reshape(self._dims)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(comm.rank(), self._dims))))
        self._groups = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = comm.new_groups(self._partition(axes))

    def _partition(self, axes: tuple) -> list:
        """The processes grouped by their coordinates off ``axes``, each group
        in the order of its index along ``axes`` (the first axis major)."""
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        arr = self._ranks.transpose(rest + pos)
        return [tuple(int(r) for r in row) for row in
                arr.reshape(-1, math.prod(self._dims[i] for i in pos))]

    def index(self, axes) -> int:
        """This process's index along ``axes`` (an axis name or a tuple of
        them, the first major; 0 along no axis)."""
        idx = 0
        for a in entry_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes) -> comm.Subgroup:
        """This process's subgroup along ``axes`` (an axis name, a tuple of
        names in any order, or None for this process alone)."""
        axes = entry_axes(axes)
        if not axes:
            return comm.Subgroup((comm.rank(),))
        canon = tuple(a for a in self.axis_names if a in axes)
        if len(canon) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of the mesh {self.axis_names}")
        sub = self._groups[canon]
        if canon == axes:
            return sub
        mine = next(p for p in self._partition(axes) if comm.rank() in p)
        return comm.Subgroup(mine, sub.handle)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 processes; (2,16,16) = 2 pods = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Scaled-down mesh with the same axis structure (8 processes)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


__all__ = ["Mesh", "make_production_mesh", "make_test_mesh"]
