"""Carry the JAX package's state into the port's layout and back.

For this system the state is the fields: the reference stores each as one
array of stacked local blocks (``grid.stacked_shape``); the port stores it
as a ``(*dims, *local_shape)`` tensor on its grid's device.
"""

from __future__ import annotations

import numpy as np

from .core.grid import ImplicitGlobalGrid


def fields_from_reference(grid: ImplicitGlobalGrid, *stacked):
    """Stacked NumPy arrays (the reference's layout) -> field tensors
    (one tensor if one array was given)."""
    out = tuple(grid.from_stacked(a) for a in stacked)
    return out[0] if len(out) == 1 else out


def fields_to_reference(grid: ImplicitGlobalGrid, *fields) -> tuple[np.ndarray, ...] | np.ndarray:
    """Field tensors -> stacked NumPy arrays in the reference's layout."""
    out = tuple(grid.to_stacked(t) for t in fields)
    return out[0] if len(out) == 1 else out
