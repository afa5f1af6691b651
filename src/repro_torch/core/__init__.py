"""Implicit global grid, Cartesian topology, halo exchange, comm hiding."""

from .grid import ImplicitGlobalGrid, init_global_grid
from .halo import update_halo
from .hide import hide_communication
from .topology import CartesianTopology, dims_create

__all__ = [
    "CartesianTopology", "ImplicitGlobalGrid", "dims_create",
    "hide_communication", "init_global_grid", "update_halo",
]
