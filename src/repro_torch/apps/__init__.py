"""Applications on the implicit global grid."""

from .heat3d import Heat3D
from .poisson import Poisson3D

__all__ = ["Heat3D", "Poisson3D"]
