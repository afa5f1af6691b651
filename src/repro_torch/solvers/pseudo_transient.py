"""Accelerated pseudo-transient iteration (damped second-order dynamics).

The paper-family solvers reach steady state by integrating a damped wave
equation in pseudo-time instead of relaxing the diffusive problem:

    V <- beta * V + alpha * R(u)
    u <- u + V

the heavy-ball / second-order Richardson method.  For an SPD operator with
spectral bounds ``lam_min <= lam(A) <= lam_max`` the optimal coefficients
give O(sqrt(kappa)) iterations instead of the O(kappa) of first-order
relaxation.  The loop runs in Python with one host read of the f64 residual
norm per iteration (the stopping test).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import synchronize
from . import reductions as red
from .cg import SolveInfo


@dataclasses.dataclass
class PTInfo(SolveInfo):
    """Solve outcome; unlike ``SolveInfo``, ``residuals`` are ABSOLUTE
    global residual L2 norms (the PT literature convention)."""

    residuals: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))


def optimal_parameters(lam_min: float, lam_max: float) -> tuple[float, float]:
    """Heavy-ball (alpha, beta) minimizing the spectral contraction rate."""
    s_min, s_max = float(lam_min) ** 0.5, float(lam_max) ** 0.5
    alpha = 4.0 / (s_max + s_min) ** 2
    beta = ((s_max - s_min) / (s_max + s_min)) ** 2
    return alpha, beta


def pseudo_transient(grid, apply_A, b, x0=None, *, lam_min: float, lam_max: float,
                     tol: float = 1e-6, maxiter: int = 10000, args=()):
    """Solve SPD ``A x = b`` by accelerated pseudo-transient iteration.

    ``apply_A(u, *args)`` is a local-view operator as in
    :func:`repro_torch.solvers.cg.cg`; ``lam_min``/``lam_max`` bound its
    spectrum.  Returns ``(x, PTInfo)`` with ``PTInfo.residuals[k]`` the
    deduplicated global residual L2 norm after iteration ``k + 1``.
    """
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    alpha, beta = optimal_parameters(lam_min, lam_max)
    t0 = time.perf_counter()
    mask = red.solve_mask(grid, b.dtype)
    mi = red.interior_mask(grid, dtype=b.dtype)
    bnorm = red.rhs_norm(grid, b, mask)
    thresh = tol * float(bnorm)
    # r (the residual at x) is carried, so the operator runs once per iteration
    r = (b - apply_A(x, *args)) * mi
    res = torch.sqrt(red.dot(grid, r, r, mask))
    v = torch.zeros_like(x)
    hist, k = [], 0
    while k < maxiter and float(res) > thresh:
        v = beta * v + alpha * r
        x = x + v
        r = (b - apply_A(x, *args)) * mi
        res = torch.sqrt(red.dot(grid, r, r, mask))
        hist.append(res.to(b.dtype))
        k += 1
    x = grid.update_halo(x)
    relres = float(res / bnorm)
    synchronize(x)
    wall = time.perf_counter() - t0
    residuals = torch.stack(hist).cpu().numpy() if hist else np.zeros(0)
    return x, PTInfo(iterations=k, relres=relres, converged=relres <= tol,
                     residuals=residuals, wall_s=wall)
