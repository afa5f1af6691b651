"""Carry the JAX package's state into the port's layout and back.

For this system the state is the fields: the reference stores each as one
array of stacked local blocks (``grid.stacked_shape``); the port stores it
as a ``(*dims, *local_shape)`` tensor on its grid's device.  Staggered
fields travel as :class:`~repro_torch.fields.Field` (a location with the
tensor) and :class:`~repro_torch.fields.FieldSet` (named Fields), e.g. the
Stokes viscosity ``eta``, forcing ``F``, pressure ``P`` and velocity ``V``.

For the language models the state is the parameters:
:func:`params_from_reference` turns the JAX package's parameter tree into
the state dict of a :class:`repro_torch.models.Model`.
"""

from __future__ import annotations

import numpy as np

import torch

from .core.grid import ImplicitGlobalGrid
from .fields import Field, FieldSet
from .models import params as pm
from .models import transformer


def fields_from_reference(grid: ImplicitGlobalGrid, *stacked):
    """Stacked NumPy arrays (the reference's layout) -> field tensors
    (one tensor if one array was given)."""
    out = tuple(grid.from_stacked(a) for a in stacked)
    return out[0] if len(out) == 1 else out


def fields_to_reference(grid: ImplicitGlobalGrid, *fields) -> tuple[np.ndarray, ...] | np.ndarray:
    """Field tensors -> stacked NumPy arrays in the reference's layout."""
    out = tuple(grid.to_stacked(t) for t in fields)
    return out[0] if len(out) == 1 else out


def field_from_reference(grid: ImplicitGlobalGrid, stacked, loc: str = "center") -> Field:
    """One stacked array of the reference (a ``repro.fields.Field``'s
    ``data``) -> a Field at ``loc``."""
    return Field(grid, grid.from_stacked(stacked), loc)


def fieldset_from_reference(grid: ImplicitGlobalGrid, **named) -> FieldSet:
    """``name=(stacked array, loc)`` pairs -> a FieldSet, in the given order."""
    return FieldSet(**{k: field_from_reference(grid, a, loc) for k, (a, loc) in named.items()})


def field_to_reference(field: Field) -> tuple[np.ndarray, str]:
    """A Field -> (stacked NumPy array, location)."""
    return field.grid.to_stacked(field.data), field.loc


def fieldset_to_reference(fset: FieldSet) -> dict:
    """A FieldSet -> ``{name: (stacked array, loc)}``, in its order."""
    return {k: field_to_reference(f) for k, f in fset.items()}


def params_from_reference(cfg, tree) -> dict:
    """The JAX package's parameter tree of ``cfg`` with NumPy leaves
    (``stacks[i]["layers"][j][name]`` with a leading repeat axis,
    ``embed``, ``final_norm``) -> the state dict of
    ``repro_torch.models.Model(cfg, state)``, as CPU tensors.  Every leaf
    maps to one parameter (transposed where the port keeps an
    ``nn.Linear`` weight); a leaf left over or missing raises."""
    leaf = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    state = transformer.state_from_tree(cfg, pm.tree_map(leaf, tree))
    transformer.check_state(cfg, state)
    return state
