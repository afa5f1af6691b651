"""Plain PyTorch versions of the fused solver hot path.

The canonical spelling of the solver-stack arithmetic, op for op as the
reference's ``kernels/solver3d/ref.py``:

* :func:`poisson_stencil` / :func:`poisson_diag` — the flux-form
  variable-coefficient Poisson operator on cell centers (division by
  ``h²``, face coefficients ``0.5 * (c0 + c±)``); ``solvers.multigrid``
  uses these, so the solver's plain path and the kernels' plain versions
  are the same function;
* :func:`face_stencil` / :func:`face_diag` — the operator on a face
  location, which is :func:`repro_torch.stencil.mac.stripped_component`
  (the MAC spelling shared with the Stokes operator and its oracle):
  roll form, wrapping inside each local block;
* :func:`apply_op_ref`, :func:`residual_op_ref`, :func:`jacobi_sweep_ref`,
  :func:`cheb_sweep_ref` — the operator, residual and smoother sweeps as
  ``make_v_cycle`` spells them (``u + omega * r / dia``, ``a * d + b * z``).
  Center: zero ring for ``A u`` and ``f - A u``, the ring of ``u`` passed
  through by the sweeps.  Face: ``A u`` raw and unmasked, the residual
  ``(f - A u) * imask``, the sweeps over the whole block (masked cells
  stay put because their residual is 0).  The center forms also take the
  optional Helmholtz ``shift`` field of :func:`poisson_stencil` (the
  smoothers' ``dia`` must already hold it).

Fields are ``(..., *local)``: the trailing ``len(spacing)`` axes are the
local block (halo included), the leading axes a batch of blocks.
Diagonals are full-shape (:func:`full_diag`: ones on the center ring, and
``dia * imask + (1 - imask)`` on faces, so division is always safe).
"""

from __future__ import annotations

import torch

from ...analysis import markers as _mk
from ...core import locations as _loc
from ...stencil import mac as _mac


def _inner(nd: int) -> tuple:
    return (Ellipsis,) + (slice(1, -1),) * nd


def _shift(a, nd: int, d: int, s: int):
    """Interior-of-other-dims slab shifted by ``s`` along local dim ``d``."""
    n = a.shape[a.ndim - nd + d]
    sl = [slice(1, -1)] * nd
    sl[d] = slice(1 + s, n - 1 + s)
    return a[(Ellipsis, *sl)]


def face_loc(loc: str, imask, shift, where: str, needs_mask: bool = True) -> int | None:
    """The stagger dim of ``loc`` (None for center); raises for a face
    location without its interior mask (where the op needs it) or with a
    Helmholtz shift (center only, as in the reference)."""
    sd = _loc.stagger_dim(loc)
    if sd is not None:
        if needs_mask and imask is None:
            raise ValueError(f"{where}: loc={loc!r} needs the interior mask (imask=...)")
        if shift is not None:
            raise ValueError(f"{where}: Helmholtz shifts are center only (got loc={loc!r})")
    return sd


def poisson_stencil(u, c, spacing, shift=None):
    """``-div(c grad u)`` (plus ``shift * u`` if a shift field is given) on
    the local interior of halo-consistent ``u``, zero on the ring."""
    # ghost demand for the analyzer (one falsy test outside a check)
    u = _mk.consume(u, radius=1, site="kernels.solver3d.ref.poisson_stencil")
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


def face_stencil(u, c, spacing, sd: int):
    """``-div(c grad u)`` for ``u`` staggered along ``sd``, ``c`` at centers:
    the CENTER coefficient along ``sd`` (the flux between like faces ``i``
    and ``i + 1`` sits at center ``i + 1``), the 4-point EDGE average across
    dims.  Unmasked: callers multiply by the location's interior mask."""
    return _mac.stripped_component(torch, u, c, spacing, sd)


def face_diag(c, spacing, sd: int):
    """Diagonal of :func:`face_stencil` (full local shape)."""
    return _mac.stripped_diag_component(torch, c, spacing, sd)


def full_diag(c, spacing, loc: str = "center", imask=None):
    """Full-shape, safe-to-divide smoother diagonal for ``loc``: center, the
    interior diagonal with ones on the ring (the ring is never updated);
    face, the masked form ``dia * imask + (1 - imask)``."""
    sd = face_loc(loc, imask, None, "full_diag")
    if sd is not None:
        return face_diag(c, spacing, sd) * imask + (1.0 - imask)
    out = torch.ones_like(c)
    out[_inner(len(spacing))] = poisson_diag(c, spacing)
    return out


def apply_op_ref(u, c, spacing, loc: str = "center", shift=None):
    """``A u``: center, the interior stencil with a zero ring; face, the
    raw unmasked roll-form stencil (callers mask)."""
    sd = face_loc(loc, None, shift, "apply_op_ref", needs_mask=False)
    if sd is not None:
        return face_stencil(u, c, spacing, sd)
    return poisson_stencil(u, c, spacing, shift)


def residual_op_ref(u, c, f, spacing, loc: str = "center", shift=None, imask=None):
    """``f - A u`` on the location's unknowns: center, on the interior with
    a zero ring; face, ``(f - A u) * imask``."""
    sd = face_loc(loc, imask, shift, "residual_op_ref")
    if sd is not None:
        return (f - face_stencil(u, c, spacing, sd)) * imask
    inner = _inner(len(spacing))
    Au = poisson_stencil(u, c, spacing, shift)
    out = torch.zeros_like(u)
    out[inner] = f[inner] - Au[inner]
    return out


def jacobi_sweep_ref(u, c, f, dia, *, omega, spacing, loc: str = "center", shift=None,
                     imask=None):
    """One damped-Jacobi sweep ``u + omega * (f - A u) / dia``: center, on
    the interior with the ring of ``u`` passed through; face, over the
    whole block (no halo update)."""
    r = residual_op_ref(u, c, f, spacing, loc, shift, imask)
    if _loc.stagger_dim(loc) is not None:
        return u + omega * r / dia
    inner = _inner(len(spacing))
    out = u.clone(memory_format=torch.contiguous_format)
    out[inner] += omega * r[inner] / dia[inner]
    return out


def cheb_sweep_ref(u, c, f, dia, d, *, a, b, spacing, loc: str = "center", shift=None,
                   imask=None):
    """One Chebyshev recurrence step -> ``(u, d)``.

    ``z = (f - A u) / dia``; the new direction is ``z / b`` when ``a`` is
    None (the first step: ``b`` is theta, ``d`` is not read) and
    ``a * d + b * z`` otherwise; ``u += d``.  Center: on the interior, the
    ring of ``u`` passed through and the ring of ``d`` zero.  Face: over
    the whole block (``z`` is 0 on masked cells).
    """
    r = residual_op_ref(u, c, f, spacing, loc, shift, imask)
    if _loc.stagger_dim(loc) is not None:
        z = r / dia
        dn = z / b if a is None else a * d + b * z
        return u + dn, dn
    inner = _inner(len(spacing))
    z = r[inner] / dia[inner]
    dn = z / b if a is None else a * d[inner] + b * z
    u_new = u.clone(memory_format=torch.contiguous_format)
    u_new[inner] += dn
    d_new = torch.zeros_like(u)
    d_new[inner] = dn
    return u_new, d_new
