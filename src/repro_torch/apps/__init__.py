"""Applications on the implicit global grid."""

from .heat3d import Heat3D
from .poisson import Poisson3D
from .stokes import StokesInfo, Stokes3D, StressCyclePreconditioner

__all__ = ["Heat3D", "Poisson3D", "Stokes3D", "StokesInfo", "StressCyclePreconditioner"]
