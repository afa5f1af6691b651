"""Staggered-field subsystem on the implicit global grid.

* :class:`Field` — a field tensor tagged with its location (``center``,
  ``xface``, ``yface``, ``zface``), shape-uniform so every location shares
  the halo machinery;
* :class:`FieldSet` — an ordered, named collection of Fields, one unknown
  vector for the solvers;
* :mod:`repro_torch.fields.ops` — interpolation and differences between
  locations;
* masks — ownership, validity and unknown masks per location.

See :mod:`repro_torch.apps.stokes` for the staggered flagship.
"""

from . import ops
from .field import (
    LOCATIONS, Field, FieldSet, face_location, from_global_fn, gather, hide_step, interior_mask,
    interior_mask_tree, map_fields, owned_mask, scatter, solve_mask, solve_mask_tree,
    stagger_dim, update_halo, valid_count, valid_global_shape, valid_mask, zeros,
)

__all__ = [
    "LOCATIONS", "Field", "FieldSet",
    "face_location", "stagger_dim", "valid_count", "valid_global_shape",
    "valid_mask", "owned_mask", "interior_mask", "solve_mask",
    "solve_mask_tree", "interior_mask_tree", "map_fields", "update_halo", "hide_step",
    "zeros", "from_global_fn", "gather", "scatter", "ops",
]
