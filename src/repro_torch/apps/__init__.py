"""Applications on the implicit global grid."""

from .gross_pitaevskii import GrossPitaevskii3D
from .heat3d import Heat3D
from .poisson import Poisson3D
from .stokes import StokesInfo, Stokes3D, StressCyclePreconditioner
from .twophase import TwoPhase3D

__all__ = ["GrossPitaevskii3D", "Heat3D", "Poisson3D", "Stokes3D", "StokesInfo",
           "StressCyclePreconditioner", "TwoPhase3D"]
