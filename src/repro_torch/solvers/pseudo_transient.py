"""Accelerated pseudo-transient iteration (damped second-order dynamics).

The paper-family solvers reach steady state by integrating a damped wave
equation in pseudo-time instead of relaxing the diffusive problem:

    V <- beta * V + alpha * R(u)
    u <- u + V

the heavy-ball / second-order Richardson method.  For an SPD operator with
spectral bounds ``lam_min <= lam(A) <= lam_max`` the optimal coefficients
give O(sqrt(kappa)) iterations instead of the O(kappa) of first-order
relaxation.  The loop runs in Python with one host read of the f64 residual
norm per iteration (the stopping test, which the health probes of
:func:`repro_torch.telemetry.watch` classify too).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import telemetry as tele
from .._device import synchronize
from ..analysis import capture as _cap
from ..analysis import markers as _mk
from ..telemetry import health as _health
from ..telemetry.flight import note_solve as _note_solve
from . import reductions as red
from .cg import SolveInfo, _epilogue, counted


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
    if _cap.capturing():   # an analyzer capture: record this solve, run nothing
        _cap.maybe_capture("pt", grid, (b, x0, *args), lambda: pseudo_transient(
            grid, apply_A, b, x0, lam_min=lam_min, lam_max=lam_max, tol=tol, maxiter=maxiter,
            args=args))
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    alpha, beta = optimal_parameters(lam_min, lam_max)
    cfg = _health.current()
    t0 = time.perf_counter()
    with counted() as col:
        mask = red.solve_mask(grid, b.dtype)
        mi = red.interior_mask(grid, dtype=b.dtype)
        bnorm = red.rhs_norm(grid, b, mask)
        bnormf = _mk.host(bnorm)
        # r (the residual at x) is carried, so the operator runs once per iteration
        r = (b - apply_A(x, *args)) * mi
        res = torch.sqrt(red.dot(grid, r, r, mask))
        # the one host read of each iteration's test
        resf = _mk.loop_float(res, site="solvers.pseudo_transient", first=True)
        probe = None if cfg is None else _health.Probe(cfg, "pt", resf, bnormf,
                                                       ranks=grid.topo.block_ranks())
        v = torch.zeros_like(x)
        hist, k, ok = [], 0, True
        while k < maxiter and resf > tol * bnormf and ok:
            with tele.tag("iteration"):
                v = beta * v + alpha * r
                x = x + v
                r = (b - apply_A(x, *args)) * mi
                res = torch.sqrt(red.dot(grid, r, r, mask))
                hist.append(res.to(b.dtype))
            k += 1
            resf = _mk.loop_float(res, site="solvers.pseudo_transient")
            if probe is not None:
                ok = probe.step(k, resf)
        x = grid.update_halo(x)
    if _mk.TRACE is not None:   # a capture stops before the host reads
        return x, None
    hist = torch.stack(hist) if hist else torch.zeros(0, dtype=b.dtype)
    relres, residuals, dstatus = _epilogue(probe, k, res / bnorm, hist, tol, maxiter)
    synchronize(x)
    wall = time.perf_counter() - t0
    info = PTInfo(iterations=k, relres=relres, converged=relres <= tol,
                  residuals=residuals, wall_s=wall,
                  comm=None if col is None else col.stats(),
                  status=_health.classify(dstatus, relres, tol, k, maxiter))
    _note_solve("pt", info)
    return x, info
