"""Plain PyTorch version of the 3-D heat-diffusion step (paper Fig. 1).

    T2[inn] = T[inn] + dt * (lam * Ci[inn] * (d2_xi(T)/dx^2
                                              + d2_yi(T)/dy^2
                                              + d2_zi(T)/dz^2))

on the trailing three axes of ``(..., nx, ny, nz)``, op for op as the
reference's ``heat_step_ref``.  The outer ring passes through (physical
boundary and halo cells belong to ``update_halo`` and the boundary
conditions, not to the stencil).
"""

from __future__ import annotations

import torch


def heat_step_ref(T, Ci, lam, dt, dx, dy, dz):
    c = T[..., 1:-1, 1:-1, 1:-1]
    d2x = (T[..., 2:, 1:-1, 1:-1] - 2.0 * c + T[..., :-2, 1:-1, 1:-1]) / (dx * dx)
    d2y = (T[..., 1:-1, 2:, 1:-1] - 2.0 * c + T[..., 1:-1, :-2, 1:-1]) / (dy * dy)
    d2z = (T[..., 1:-1, 1:-1, 2:] - 2.0 * c + T[..., 1:-1, 1:-1, :-2]) / (dz * dz)
    Tn = c + dt * (lam * Ci[..., 1:-1, 1:-1, 1:-1] * (d2x + d2y + d2z))
    out = T.clone(memory_format=torch.contiguous_format)
    out[..., 1:-1, 1:-1, 1:-1] = Tn.to(T.dtype)
    return out
