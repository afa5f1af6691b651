"""Applications on the implicit global grid."""

from .heat3d import Heat3D

__all__ = ["Heat3D"]
