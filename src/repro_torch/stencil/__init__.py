"""Finite-difference helpers (ParallelStencil's FiniteDifferences3D)."""
