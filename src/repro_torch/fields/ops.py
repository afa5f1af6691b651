"""Interpolation and difference operators between staggering locations.

``fd3d``-style finite differences, but location-aware and shape-preserving:
every op takes and returns tensors of the full local shape on the trailing
``nd`` axes (default 3; leading axes, e.g. the block axes of a field, are a
batch), writing zeros into the cells that have no defined value (the dead
plane for center -> face ops, the leading plane for face -> center ops).

Conventions (face ``i`` sits between centers ``i`` and ``i + 1``):

    diff_to_face:    f[i] = (c[i+1] - c[i]) / h          valid i < n-1
    avg_to_face:     f[i] = (c[i] + c[i+1]) / 2          valid i < n-1
    diff_to_center:  c[i] = (f[i] - f[i-1]) / h          valid i >= 1
    avg_to_center:   c[i] = (f[i-1] + f[i]) / 2          valid i >= 1
    avg_to_edge:     e[i,j] = 4-point average            valid i,j < n-1

All ops are local (no communication) and valid wherever their inputs are
halo-consistent; the zero planes they write include each block's copy of
cells a neighbour computes, so halo-update the result before gathering it
or before ops that read those planes.  The Field-level wrappers
(:func:`grad`, :func:`div`, :func:`to_face`, :func:`to_center`) check and
produce locations.
"""

from __future__ import annotations

import torch

from .field import Field, FieldSet, face_location

__all__ = [
    "diff_to_face", "diff_to_center", "avg_to_face", "avg_to_center",
    "avg_to_edge", "to_face", "to_center", "grad", "div",
]


def _sd(nd: int, d: int, start, stop) -> tuple:
    s: list = [slice(None)] * nd
    s[d] = slice(start, stop)
    return (Ellipsis, *s)


def _spacing(spacing, ndims: int):
    """``spacing`` as a per-dim tuple (a scalar broadcasts).  Every location
    shares the center spacing under shape-uniform staggering."""
    if isinstance(spacing, (int, float)):
        return (float(spacing),) * ndims
    sp = tuple(float(s) for s in spacing)
    if len(sp) < ndims:
        raise ValueError(f"spacing {spacing!r} has {len(sp)} entries for a {ndims}-D grid")
    return sp


def _into(like, idx, out):
    res = torch.zeros_like(like)
    res[idx] = out
    return res


def diff_to_face(c, d: int, h: float = 1.0, nd: int = 3):
    """Center -> face-``d`` forward difference; dead plane zero."""
    out = (c[_sd(nd, d, 1, None)] - c[_sd(nd, d, 0, -1)]) / h
    return _into(c, _sd(nd, d, 0, -1), out)


def avg_to_face(c, d: int, nd: int = 3):
    """Center -> face-``d`` two-point average; dead plane zero."""
    out = 0.5 * (c[_sd(nd, d, 0, -1)] + c[_sd(nd, d, 1, None)])
    return _into(c, _sd(nd, d, 0, -1), out)


def diff_to_center(f, d: int, h: float = 1.0, nd: int = 3):
    """Face-``d`` -> center backward difference; leading plane zero."""
    out = (f[_sd(nd, d, 1, None)] - f[_sd(nd, d, 0, -1)]) / h
    return _into(f, _sd(nd, d, 1, None), out)


def avg_to_center(f, d: int, nd: int = 3):
    """Face-``d`` -> center two-point average; leading plane zero."""
    out = 0.5 * (f[_sd(nd, d, 0, -1)] + f[_sd(nd, d, 1, None)])
    return _into(f, _sd(nd, d, 1, None), out)


def avg_to_edge(c, d1: int, d2: int, nd: int = 3):
    """Center -> edge staggered along both ``d1`` and ``d2`` (4-point
    average); dead planes along both dims zero."""
    if d1 == d2:
        raise ValueError("edge dims must differ")
    a = c[_sd(nd, d1, 0, -1)] + c[_sd(nd, d1, 1, None)]
    b = a[_sd(nd, d2, 0, -1)] + a[_sd(nd, d2, 1, None)]
    dst: list = [slice(None)] * nd
    dst[d1] = slice(0, -1)
    dst[d2] = slice(0, -1)
    return _into(c, (Ellipsis, *dst), 0.25 * b)


# ---------------------------------------------------------------------------
# Field-level wrappers (location-checked)
# ---------------------------------------------------------------------------

def to_face(f: Field, d: int) -> Field:
    """Interpolate a center Field onto the ``d``-faces."""
    if f.loc != "center":
        raise ValueError(f"to_face expects a center field, got {f.loc!r}")
    return Field(f.grid, avg_to_face(f.data, d, f.grid.ndims), face_location(d))


def to_center(f: Field) -> Field:
    """Interpolate a face Field back onto the centers."""
    sd = f.stagger_dim
    if sd is None:
        raise ValueError("to_center expects a face field")
    return Field(f.grid, avg_to_center(f.data, sd, f.grid.ndims), "center")


def grad(p: Field, spacing) -> FieldSet:
    """Center Field -> FieldSet ``x``, ``y``, ``z`` of the face-located
    components of its gradient (``spacing`` per dim, or one scalar)."""
    if p.loc != "center":
        raise ValueError(f"grad expects a center field, got {p.loc!r}")
    nd = p.grid.ndims
    sp = _spacing(spacing, nd)
    names = ("x", "y", "z")
    return FieldSet(**{names[d]: Field(p.grid, diff_to_face(p.data, d, sp[d], nd),
                                       face_location(d)) for d in range(nd)})


def div(V: FieldSet, spacing) -> Field:
    """FieldSet of face components, each staggered along a distinct dim ->
    center Field of the divergence."""
    acc = grid = None
    seen: set = set()
    for f in V:
        sd = f.stagger_dim
        if sd is None:
            raise ValueError("div expects face-located components")
        if sd in seen:
            raise ValueError(f"div got two components staggered along dim {sd}")
        seen.add(sd)
        grid = f.grid
        sp = _spacing(spacing, grid.ndims)
        term = diff_to_center(f.data, sd, sp[sd], grid.ndims)
        acc = term if acc is None else acc + term
    return Field(grid, acc, "center")
