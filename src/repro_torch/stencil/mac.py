"""Staggered (MAC) viscous-block stencils, parameterised by array module.

The one spelling of the staggered variable-viscosity operator, shared by
the Stokes operator (:mod:`repro_torch.apps.stokes`, ``xp = torch`` on
fields), the Stokes NumPy oracle (``xp = numpy`` on the gathered global
arrays) and the face-located multigrid operator
(``kernels/solver3d/ref.py::face_stencil``), op for op as the reference's
``stencil/mac.py``.

Geometry (shape-uniform MAC staggering of :mod:`repro_torch.fields`):
velocity component ``d`` lives on ``d``-faces (entry ``i`` along ``d`` at
``i + 1/2``), viscosity ``eta`` at centers.  All stencils are roll-form:
the value at index ``i`` reads ``i + s`` through ``roll(xp, a, d, s)``,
which wraps inside the LOCAL block, never into a neighbouring block.  The
spatial dims are the trailing ``len(spacing)`` axes (``nd``); leading axes
(the block axes of a field) are a batch, so ``d`` is axis ``a.ndim - nd +
d``.  Wrapped planes land only on ring, halo or dead cells, which every
caller masks or refreshes.
"""

from __future__ import annotations

import torch

from ..analysis import markers as _mk


def _consume(xp, a, site: str):
    """Ghost demand for the analyzer — torch consumers only (the NumPy
    oracle shares this spelling and is never checked)."""
    return _mk.consume(a, radius=1, site=site) if xp is torch else a


def _xp_roll(xp, a, shift: int, axis: int):
    """``roll`` of numpy or torch: the one place the two spellings differ."""
    if xp is torch:
        return torch.roll(a, shift, axis)
    return xp.roll(a, shift, axis=axis)


def roll(xp, a, d: int, s: int, nd: int = 3):
    """Value at index ``i`` becomes ``a[i + s]`` along spatial dim ``d`` of
    the trailing ``nd`` axes."""
    return _xp_roll(xp, a, -s, a.ndim - nd + d)


def edge_avg(xp, c, d1: int, d2: int, nd: int = 3):
    """Center field -> 4-point average at the (d1, d2) edges; entry
    ``[i, j]`` is the edge ``(i + 1/2, j + 1/2)``."""
    a = c + roll(xp, c, d1, +1, nd)
    return 0.25 * (a + roll(xp, a, d2, +1, nd))


def _acc(acc, t):
    # the reference starts from zeros_like(u); 0 + t == t, one pass fewer
    return t if acc is None else acc + t


# ---------------------------------------------------------------------------
# stripped (decoupled) viscous block: -div(eta grad v_d) per component
# ---------------------------------------------------------------------------

def stripped_component(xp, u, eta, spacing, d: int):
    """``-div(eta grad u)`` for ``u`` staggered along ``d``.

    CENTER ``eta`` along the component's own dim (the flux between like
    faces ``i`` and ``i + 1`` sits at center ``i + 1``), 4-point EDGE
    average across dims.  Unmasked; callers zero everything outside the
    component's unknown faces.
    """
    u = _consume(xp, u, "stencil.mac.stripped_component")
    nd = len(spacing)
    h2 = [float(s) ** 2 for s in spacing]
    acc = None
    for dd in range(nd):
        if dd == d:
            ep = roll(xp, eta, d, +1, nd)
            acc = _acc(acc, (ep * (roll(xp, u, d, +1, nd) - u)
                             - eta * (u - roll(xp, u, d, -1, nd))) / h2[d])
        else:
            ee = edge_avg(xp, eta, d, dd, nd)
            acc = _acc(acc, (ee * (roll(xp, u, dd, +1, nd) - u)
                             - roll(xp, ee, dd, -1, nd)
                             * (u - roll(xp, u, dd, -1, nd))) / h2[dd])
    return -acc


def stripped_diag_component(xp, eta, spacing, d: int):
    """Diagonal of :func:`stripped_component` (full shape, for Jacobi)."""
    nd = len(spacing)
    h2 = [float(s) ** 2 for s in spacing]
    dia = None
    for dd in range(nd):
        if dd == d:
            dia = _acc(dia, (eta + roll(xp, eta, d, +1, nd)) / h2[d])
        else:
            ee = edge_avg(xp, eta, d, dd, nd)
            dia = _acc(dia, (ee + roll(xp, ee, dd, -1, nd)) / h2[dd])
    return dia


def stripped_apply(xp, V, eta, spacing):
    """Per-component viscous block over the sequence ``V`` (no coupling)."""
    return [stripped_component(xp, V[d], eta, spacing, d) for d in range(len(V))]


def stripped_diag(xp, eta, spacing):
    """Per-component diagonals of :func:`stripped_apply`."""
    return [stripped_diag_component(xp, eta, spacing, d) for d in range(len(spacing))]


# ---------------------------------------------------------------------------
# full symmetric-gradient stress: -div(2 eta D(V)) per component
# ---------------------------------------------------------------------------

def full_stress_apply(xp, V, eta, spacing):
    """Full-stress momentum operator ``-div(2 eta D(V))`` per component.

    Component ``d`` of the result is

        -[ d_d(2 eta d_d v_d) + sum_{dd != d} d_dd( eta_e (d_dd v_d + d_d v_dd) ) ]

    with the normal stress on centers (CENTER ``eta``) and the shear stress
    ``tau_{d,dd}`` on the (d, dd) edges (EDGE-averaged ``eta``).  Returns
    the unmasked result per component.
    """
    V = [_consume(xp, v, "stencil.mac.full_stress_apply") for v in V]
    nd = len(V)
    h = [float(s) for s in spacing]
    out = []
    for d in range(nd):
        u = V[d]
        acc = None
        for dd in range(nd):
            if dd == d:
                ep = roll(xp, eta, d, +1, nd)
                acc = _acc(acc, 2.0 * (ep * (roll(xp, u, d, +1, nd) - u)
                                       - eta * (u - roll(xp, u, d, -1, nd))) / (h[d] * h[d]))
            else:
                ee = edge_avg(xp, eta, d, dd, nd)
                # tau_{d,dd} at edge (i+1/2, j+1/2): d_dd v_d plus the
                # coupling term d_d v_dd
                tau = ee * ((roll(xp, u, dd, +1, nd) - u) / h[dd]
                            + (roll(xp, V[dd], d, +1, nd) - V[dd]) / h[d])
                acc = _acc(acc, (tau - roll(xp, tau, dd, -1, nd)) / h[dd])
        out.append(-acc)
    return out


def full_stress_diag(xp, eta, spacing):
    """Per-component diagonal of :func:`full_stress_apply`: the stripped one
    with the own-dim coefficient doubled (the coupling term never touches a
    component's own diagonal)."""
    nd = len(spacing)
    h2 = [float(s) ** 2 for s in spacing]
    out = []
    for d in range(nd):
        dia = None
        for dd in range(nd):
            if dd == d:
                dia = _acc(dia, 2.0 * (eta + roll(xp, eta, d, +1, nd)) / h2[d])
            else:
                ee = edge_avg(xp, eta, d, dd, nd)
                dia = _acc(dia, (ee + roll(xp, ee, dd, -1, nd)) / h2[dd])
        out.append(dia)
    return out
