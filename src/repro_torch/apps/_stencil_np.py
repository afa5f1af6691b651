"""The staggered-stencil arithmetic of the Stokes operator and its NumPy
oracle under the apps-local name; the one spelling lives in
:mod:`repro_torch.stencil.mac` (``xp``-parameterised, so the operator and
the oracle cannot drift apart)."""

from __future__ import annotations

from ..stencil.mac import (  # noqa: F401
    edge_avg, full_stress_apply, full_stress_diag, roll, stripped_apply, stripped_component,
    stripped_diag, stripped_diag_component,
)

__all__ = [
    "roll", "edge_avg", "stripped_apply", "stripped_component", "stripped_diag",
    "stripped_diag_component", "full_stress_apply", "full_stress_diag",
]
