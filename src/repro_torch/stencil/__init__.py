"""Finite-difference helpers (ParallelStencil's FiniteDifferences2D and 3D)."""
