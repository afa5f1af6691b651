"""Implicit global grid, Cartesian topology, halo exchange, comm hiding,
boundary conditions."""

from . import boundary
from .grid import ImplicitGlobalGrid, init_global_grid
from .halo import update_halo
from .hide import hide_apply, hide_communication
from .topology import CartesianTopology, dims_create

__all__ = [
    "boundary", "CartesianTopology", "ImplicitGlobalGrid", "dims_create",
    "hide_apply", "hide_communication", "init_global_grid", "update_halo",
]
