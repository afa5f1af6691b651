"""Plain PyTorch versions of the fused solver hot path (center location).

The canonical spelling of the solver-stack arithmetic, op for op as the
reference's ``kernels/solver3d/ref.py``:

* :func:`poisson_stencil` / :func:`poisson_diag` — the flux-form
  variable-coefficient Poisson operator on cell centers (division by
  ``h²``, face coefficients ``0.5 * (c0 + c±)``); ``solvers.multigrid``
  uses these, so the solver's plain path and the kernels' plain versions
  are the same function;
* :func:`apply_op_ref`, :func:`residual_op_ref`, :func:`jacobi_sweep_ref`,
  :func:`cheb_sweep_ref` — the operator, residual and smoother sweeps as
  ``make_v_cycle`` spells them (``u + omega * r / dia``, ``a * d + b * z``).
  Each also takes the optional Helmholtz ``shift`` field of
  :func:`poisson_stencil`, which the kernels do not take yet.

Fields are ``(..., *local)``: the trailing ``len(spacing)`` axes are the
local block (halo included), the leading axes a batch of blocks.
Diagonals are full-shape (:func:`full_diag`: ones on the ring, so division
is always safe).  Face locations belong to the staggered slice of the port
and raise.
"""

from __future__ import annotations

import torch

from ...core import locations as _loc


def _inner(nd: int) -> tuple:
    return (Ellipsis,) + (slice(1, -1),) * nd


def _shift(a, nd: int, d: int, s: int):
    """Interior-of-other-dims slab shifted by ``s`` along local dim ``d``."""
    n = a.shape[a.ndim - nd + d]
    sl = [slice(1, -1)] * nd
    sl[d] = slice(1 + s, n - 1 + s)
    return a[(Ellipsis, *sl)]


def center_only(loc: str, where: str) -> None:
    """Raise for a face location: those variants come with the staggered
    slice of the port (``fields/`` and the face kernels)."""
    if _loc.stagger_dim(loc) is not None:
        raise NotImplementedError(
            f"{where}: loc={loc!r} is a face location; the face variants are ported "
            "with the staggered-fields slice (center only for now)")


def poisson_stencil(u, c, spacing, shift=None):
    """``-div(c grad u)`` (plus ``shift * u`` if a shift field is given) on
    the local interior of halo-consistent ``u``, zero on the ring."""
    nd = len(spacing)
    inner = _inner(nd)
    u0 = u[inner]
    c0 = c[inner]
    acc = torch.zeros_like(u0)
    for d in range(nd):
        up, um = _shift(u, nd, d, +1), _shift(u, nd, d, -1)
        cp, cm = _shift(c, nd, d, +1), _shift(c, nd, d, -1)
        cf_p = 0.5 * (c0 + cp)
        cf_m = 0.5 * (c0 + cm)
        acc = acc + (cf_p * (up - u0) - cf_m * (u0 - um)) / spacing[d] ** 2
    out = -acc if shift is None else shift[inner] * u0 - acc
    res = torch.zeros_like(u)
    res[inner] = out
    return res


def poisson_diag(c, spacing):
    """Interior diagonal of the flux-form operator (for Jacobi)."""
    nd = len(spacing)
    c0 = c[_inner(nd)]
    dia = torch.zeros_like(c0)
    for d in range(nd):
        cf_p = 0.5 * (c0 + _shift(c, nd, d, +1))
        cf_m = 0.5 * (c0 + _shift(c, nd, d, -1))
        dia = dia + (cf_p + cf_m) / spacing[d] ** 2
    return dia


def full_diag(c, spacing, loc: str = "center"):
    """Full-shape, safe-to-divide smoother diagonal: the interior diagonal
    with ones on the ring (the ring is never updated)."""
    center_only(loc, "full_diag")
    out = torch.ones_like(c)
    out[_inner(len(spacing))] = poisson_diag(c, spacing)
    return out


def apply_op_ref(u, c, spacing, loc: str = "center", shift=None):
    """``A u``: the interior stencil, zero on the ring."""
    center_only(loc, "apply_op_ref")
    return poisson_stencil(u, c, spacing, shift)


def residual_op_ref(u, c, f, spacing, loc: str = "center", shift=None):
    """``f - A u`` on the interior, zero on the ring."""
    center_only(loc, "residual_op_ref")
    inner = _inner(len(spacing))
    Au = poisson_stencil(u, c, spacing, shift)
    out = torch.zeros_like(u)
    out[inner] = f[inner] - Au[inner]
    return out


def jacobi_sweep_ref(u, c, f, dia, *, omega, spacing, loc: str = "center", shift=None):
    """One damped-Jacobi sweep ``u + omega * (f - A u) / dia`` on the
    interior; the ring of ``u`` passes through (no halo update)."""
    inner = _inner(len(spacing))
    r = residual_op_ref(u, c, f, spacing, loc, shift)
    out = u.clone(memory_format=torch.contiguous_format)
    out[inner] += omega * r[inner] / dia[inner]
    return out


def cheb_sweep_ref(u, c, f, dia, d, *, a, b, spacing, loc: str = "center", shift=None):
    """One Chebyshev recurrence step -> ``(u, d)``.

    ``z = (f - A u) / dia``; the new direction is ``z / b`` when ``a`` is
    None (the first step: ``b`` is theta, ``d`` is not read) and
    ``a * d + b * z`` otherwise; ``u += d`` on the interior.  The ring of
    ``u`` passes through; the ring of ``d`` is zero.
    """
    inner = _inner(len(spacing))
    r = residual_op_ref(u, c, f, spacing, loc, shift)
    z = r[inner] / dia[inner]
    dn = z / b if a is None else a * d[inner] + b * z
    u_new = u.clone(memory_format=torch.contiguous_format)
    u_new[inner] += dn
    d_new = torch.zeros_like(u)
    d_new[inner] = dn
    return u_new, d_new
