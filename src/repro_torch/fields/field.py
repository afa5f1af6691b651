"""Staggered fields on the implicit global grid.

Pressure-like scalars live in cell centers, velocities and fluxes on cell
faces.  A :class:`Field` makes the location a property of the field
instead of a convention every app hand-rolls.

Storage (shape-uniform staggering, as the reference): a Field at any
location holds a tensor of the same shape as a center field, the grid's
``(*dims, *local)``; the location changes the interpretation:

* ``center``: entry ``i`` sits at node ``i`` (coordinate ``i * h``);
* ``xface`` (``yface``, ``zface``): entry ``i`` along the staggered dim sits
  at the face ``i + 1/2`` between centers ``i`` and ``i + 1``; the trailing
  plane ``i = N - 1`` has no face and is a masked **dead plane** (kept 0).

Face index ``i`` is aligned with center index ``i``, so neighbouring blocks
share face planes exactly where they share center planes and the one
``update_halo`` serves every location.  What depends on the location is
the bookkeeping, provided here: valid shapes (``N - 1`` faces along the
staggered dim), ownership/validity/unknown masks, gather/scatter of the
valid array.  Boundary conditions are in :mod:`repro_torch.core.boundary`.

A :class:`FieldSet` is an ordered, named collection of Fields that the
solvers take as one unknown vector (through the duck-typed tree helpers of
:mod:`repro_torch.core.locations`); :func:`hide_step` is ``grid.hide`` over
a FieldSet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import halo as _halo
from ..core import hide as _hide
from ..core import locations as _loc
from ..core.locations import LOCATIONS, face_location, stagger_dim  # noqa: F401
from ..core.locations import node_map as map_fields  # Fields as the leaves
from ..solvers import reductions as red


def valid_count(grid, loc: str, dim: int) -> int:
    """Number of valid global points along ``dim`` for a field at ``loc``."""
    n = grid.n_g(dim)
    return n - 1 if stagger_dim(loc) == dim else n


def valid_global_shape(grid, loc: str) -> tuple[int, ...]:
    """Deduplicated global shape of the valid points of a field at ``loc``."""
    return tuple(valid_count(grid, loc, d) for d in range(grid.ndims))


class Field:
    """A field tensor ``(*dims, *local)`` tagged with its staggering
    location.  Elementwise arithmetic with scalars, tensors and Fields of
    the same location gives Fields."""

    _staggered_tree = True   # duck-typed marker (core.locations.is_field_node)

    def __init__(self, grid, data, loc: str = "center"):
        sd = stagger_dim(loc)
        if sd is not None and sd >= grid.ndims:
            raise ValueError(f"location {loc!r} needs grid dim {sd}, but grid is {grid.ndims}-D")
        self.grid = grid
        self.data = data
        self.loc = loc

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def stagger_dim(self) -> int | None:
        return stagger_dim(self.loc)

    @property
    def valid_global_shape(self) -> tuple[int, ...]:
        return valid_global_shape(self.grid, self.loc)

    def with_data(self, data) -> "Field":
        return Field(self.grid, data, self.loc)

    def __repr__(self):
        return f"Field({self.loc}, shape={tuple(self.data.shape)})"

    # -- location-aware masks -------------------------------------------
    def valid_mask(self):
        return valid_mask(self.grid, self.loc, self.dtype)

    def owned_mask(self):
        return owned_mask(self.grid, self.loc, self.dtype)

    def interior_mask(self):
        return interior_mask(self.grid, self.loc, self.dtype)

    def solve_mask(self):
        return solve_mask(self.grid, self.loc, self.dtype)

    # -- elementwise arithmetic -----------------------------------------
    def _coerce(self, other):
        if isinstance(other, Field):
            if other.loc != self.loc:
                raise ValueError(f"location mismatch: {self.loc} vs {other.loc} "
                                 "(interpolate with repro_torch.fields.ops first)")
            return other.data
        return other

    def __add__(self, o):
        return self.with_data(self.data + self._coerce(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self.with_data(self.data - self._coerce(o))

    def __rsub__(self, o):
        return self.with_data(self._coerce(o) - self.data)

    def __mul__(self, o):
        return self.with_data(self.data * self._coerce(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self.with_data(self.data / self._coerce(o))

    def __neg__(self):
        return self.with_data(-self.data)


class FieldSet:
    """An ordered, named collection of Fields, e.g. ``FieldSet(vx=..., vy=...,
    vz=...)``: one unknown vector for the solvers."""

    _staggered_tree = True   # duck-typed marker (core.locations.is_field_set)

    def __init__(self, **fields):
        self._fields = dict(fields)

    def __getattr__(self, name):
        fields = self.__dict__.get("_fields", {})
        if name in fields:
            return fields[name]
        raise AttributeError(name)

    def __getitem__(self, name):
        return self._fields[name]

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def map(self, fn: Callable[[Field], Field]) -> "FieldSet":
        return FieldSet(**{k: fn(v) for k, v in self._fields.items()})

    def __repr__(self):
        inner = ", ".join(f"{k}={v.loc}" for k, v in self._fields.items())
        return f"FieldSet({inner})"


# ---------------------------------------------------------------------------
# location-aware masks (a field each; every block gets its own)
# ---------------------------------------------------------------------------

def valid_mask(grid, loc: str, dtype=None):
    """1.0 on real points of ``loc`` (excludes the staggered dead plane)."""
    return _loc.valid_mask(grid, loc, dtype)


def owned_mask(grid, loc: str, dtype=None):
    """Deduplicated ownership over the valid points of ``loc``: center
    ownership intersected with validity (drops the dead plane)."""
    dtype = dtype or grid.dtype
    return red.owned_mask(grid, dtype) * valid_mask(grid, loc, dtype)


def interior_mask(grid, loc: str, dtype=None):
    """1.0 on the unknowns of a field at ``loc`` (see
    :func:`repro_torch.core.locations.interior_mask`)."""
    return _loc.interior_mask(grid, loc, dtype)


def solve_mask(grid, loc: str, dtype=None):
    """Reduction mask over the unknowns of ``loc``, each counted once."""
    return red.loc_solve_mask(grid, loc, dtype)


def _mask_tree(grid, tree, mask_fn):
    """Structure-matching tree of masks: Field-wrapped masks for Fields,
    center masks for bare tensors."""
    def one(node):
        if isinstance(node, Field):
            return node.with_data(mask_fn(node.grid, node.loc, node.dtype))
        return mask_fn(grid, "center", node.dtype)

    return map_fields(one, tree)


def solve_mask_tree(grid, tree):
    return _mask_tree(grid, tree, solve_mask)


def interior_mask_tree(grid, tree):
    return _mask_tree(grid, tree, interior_mask)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

def update_halo(grid, tree, width: int | None = None):
    """Halo exchange of every Field (and bare tensor) of ``tree``: one
    ``update_halo`` per leaf, in place, location-independent under
    shape-uniform staggering (periodic dims included: the send slabs never
    hold the dead plane).  Returns ``tree``."""
    w = grid.halo if width is None else width

    def one(node):
        if isinstance(node, Field):
            _halo.update_halo(grid.topo, node.data, width=w, locations=(node.loc,))
            return node
        return _halo.update_halo(grid.topo, node, width=w)

    return map_fields(one, tree)


def _structure(fset: FieldSet) -> tuple:
    return tuple((name, f.loc) for name, f in fset.items())


def hide_step(grid, step_fn, fset: FieldSet, width=(16, 2, 2)) -> FieldSet:
    """``grid.hide`` for FieldSet steps: bitwise equal to
    ``update_halo(grid, step_fn(fset))``.

    ``step_fn(fset) -> fset`` maps a FieldSet to one of the same structure
    (names and locations; anything else raises); the boundary-shell /
    interior split and the overlapped halo exchange of
    :func:`repro_torch.core.hide.hide_communication` run on the Fields'
    tensors.  Periodic dims work for every location, as in
    :func:`update_halo`.
    """
    structure = _structure(fset)

    def raw_step(*tensors):
        out = step_fn(FieldSet(**{name: Field(grid, t, loc)
                                  for (name, loc), t in zip(structure, tensors)}))
        if not isinstance(out, FieldSet) or _structure(out) != structure:
            raise ValueError(f"hide_step: step_fn must preserve the FieldSet structure "
                             f"{structure}, got {out!r}")
        return tuple(f.data for f in out)

    outs = _hide.hide_communication(grid.topo, raw_step, [f.data for f in fset],
                                    width=tuple(width)[:grid.ndims], halo=grid.halo)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return FieldSet(**{name: Field(grid, t, loc) for (name, loc), t in zip(structure, outs)})


# ---------------------------------------------------------------------------
# allocation / IO
# ---------------------------------------------------------------------------

def zeros(grid, loc: str = "center", dtype=None) -> Field:
    return Field(grid, grid.zeros(dtype), loc)


def from_global_fn(grid, fn, loc: str = "center", dtype=None) -> Field:
    """Field initialised as ``fn(ix, iy, iz)`` of global point indices.  For
    a face location, index ``i`` along the staggered dim is the face at
    ``(i + 1/2) * h`` (shift inside ``fn``); the dead plane is zeroed."""
    sd = stagger_dim(loc)

    def wrapped(*idx):
        v = torch.as_tensor(fn(*idx))
        if sd is not None:
            v = torch.where(idx[sd] < grid.n_g(sd) - 1, v, torch.zeros((), dtype=v.dtype))
        return v

    return Field(grid, grid.from_global_fn(wrapped, dtype), loc)


def gather(field: Field) -> np.ndarray:
    """Deduplicated global NumPy array of the valid points of ``field``."""
    g = field.grid
    a = g.gather(field.data)
    sd = field.stagger_dim
    if sd is not None:
        a = a[tuple(slice(0, -1) if d == sd else slice(None) for d in range(g.ndims))]
    return a


def scatter(grid, G, loc: str = "center", dtype=None) -> Field:
    """Inverse of :func:`gather`: valid global array -> Field."""
    G = np.asarray(G)
    want = valid_global_shape(grid, loc)
    if tuple(G.shape) != want:
        raise ValueError(f"expected valid shape {want} for {loc!r}, got {G.shape}")
    sd = stagger_dim(loc)
    if sd is not None:
        G = np.pad(G, [(0, 1) if d == sd else (0, 0) for d in range(grid.ndims)])
    return Field(grid, grid.scatter(G, dtype=dtype), loc)
