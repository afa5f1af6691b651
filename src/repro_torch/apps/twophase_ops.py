"""Matrix-free operators of the implicit two-phase pressure solve.

The backward-Euler step of the effective-pressure equation (see
:mod:`repro_torch.apps.twophase`) solves, with the nonlinear coefficients
``k = k(phi^n)`` and ``eta = eta_phi(phi^n)`` frozen at the old porosity,

    (1/dt + 1/eta) Pe^{n+1} - div( k grad Pe^{n+1} ) = Pe^n / dt - G

where ``G = d/dz (k_zface)`` is the divergence of the buoyancy part of the
Darcy flux.  The left-hand side is the flux-form Poisson operator of
:mod:`repro_torch.solvers.multigrid` plus the positive diagonal ``1/dt +
1/eta``: symmetric positive definite for any ``dt > 0``.  On a CUDA tensor
it is kernel K2 with that diagonal as its Helmholtz shift.

Fields are ``(*dims, *local)`` tensors; every function acts on the trailing
three axes.
"""

from __future__ import annotations

import torch

from ..fields import ops as fops
from ..solvers.multigrid import poisson_apply

_INNER = (Ellipsis, slice(1, -1), slice(1, -1), slice(1, -1))


def pressure_apply(grid, u, k, diag, spacing, update_halo=True, hide=False,
                   use_kernel: str = "auto"):
    """Implicit pressure operator ``diag*u - div(k grad u)``; zero ring.

    :func:`repro_torch.solvers.multigrid.poisson_apply` with the Helmholtz
    ``shift`` bound to ``diag = 1/dt + 1/eta_phi``: the same stencil the
    multigrid cycle smooths.  ``k``/``diag`` must be halo-consistent.
    ``hide=True`` applies it to a halo-updated copy of ``u``
    (:func:`repro_torch.core.hide.hide_apply`).
    """
    return poisson_apply(grid, u, k, spacing, update_halo=update_halo, hide=hide, shift=diag,
                         use_kernel=use_kernel)


def pressure_rhs(Pe, k, dt, dz):
    """Backward-Euler right-hand side ``Pe/dt - d_z(k_zface)``; zero ring."""
    G = fops.diff_to_center(fops.avg_to_face(k, 2), 2, dz)
    out = torch.zeros_like(Pe)
    out[_INNER] = Pe[_INNER] / dt - G[_INNER]
    return out


def darcy_flux(Pe, k, spacing, buoyancy=1.0):
    """Staggered Darcy fluxes ``q = -k_face (grad Pe - buoyancy e_z)``.

    Returns raw ``(qx, qy, qz)`` face tensors (dead planes zero); wrap them
    as face Fields and halo-update them before gathering.
    """
    qx = -fops.avg_to_face(k, 0) * fops.diff_to_face(Pe, 0, spacing[0])
    qy = -fops.avg_to_face(k, 1) * fops.diff_to_face(Pe, 1, spacing[1])
    kz = fops.avg_to_face(k, 2)
    qz = -kz * (fops.diff_to_face(Pe, 2, spacing[2]) - buoyancy)
    return qx, qy, qz
