"""Public fused solver ops: the CUDA kernels K2-K5 or their plain versions.

Each entry point takes ``use_kernel="auto"|"cuda"|"ref"`` and decides with
:func:`resolve`: ``"auto"`` launches the kernel on a CUDA tensor and runs
the plain version (:mod:`.ref`) on a CPU tensor; whatever the kernel does
not take raises.  This module is the one place where the solvers choose
between the two.  Conventions (those of ``repro_torch.solvers.multigrid``):

* fields are ``(..., nx, ny, nz)`` local blocks INCLUDING the halo ring;
  the caller owns the halo exchange (one ``update_halo`` per sweep);
* ``loc`` in {"center", "xface", "yface", "zface"}: a face location runs
  the face variant (``*_face_cuda``) and needs the location's ``imask``
  for the residual and the sweeps;
* diagonals are full-shape and safe to divide (``ref.full_diag``; with a
  shift, the shift is part of the diagonal: the kernels do not add it);
* ``shift`` (an optional Helmholtz field, ``A u = shift * u - div(c grad
  u)``) is center only: the center kernels take it, a face location with a
  shift raises under every ``use_kernel``.
"""

from __future__ import annotations

from ...core.locations import stagger_dim
from .. import dispatch
from . import ref
from .kernel import (apply_cuda, apply_face_cuda, cheb_cuda, cheb_face_cuda, jacobi_cuda,
                     jacobi_face_cuda, residual_cuda, residual_face_cuda)


def _h2(spacing) -> tuple:
    return tuple(float(s) ** 2 for s in spacing)


def resolve(use_kernel, x, spacing, *, loc: str = "center", shift=None, imask=None,
            needs_mask: bool = False, where: str = "solver3d") -> str:
    """``"cuda"`` or ``"ref"`` for a solver op on tensor ``x``; raises for a
    face ``loc`` without its ``imask`` (where ``needs_mask``) or with a
    ``shift``, and for a grid that is not 3-D where the kernel would
    run."""
    ref.face_loc(loc, imask, shift, where, needs_mask=needs_mask)
    if dispatch.resolve(use_kernel, x, where=where) == "ref":
        return "ref"
    if len(spacing) != 3:
        raise ValueError(f"{where}: the CUDA kernels are 3-D, got a {len(spacing)}-D grid")
    return "cuda"


def apply_op(u, c, *, spacing, loc: str = "center", shift=None, use_kernel: str = "auto"):
    """Fused ``A u``: center, the interior stencil with a zero ring; face,
    the raw unmasked roll-form stencil (callers mask)."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift, where="solver3d.apply_op") == "ref":
        return ref.apply_op_ref(u, c, spacing, loc, shift=shift)
    sd = stagger_dim(loc)
    if sd is not None:
        return apply_face_cuda(u, c, sd=sd, h2=_h2(spacing))
    return apply_cuda(u, c, h2=_h2(spacing), shift=shift)


def residual_op(u, c, f, *, spacing, loc: str = "center", shift=None, imask=None,
                use_kernel: str = "auto"):
    """Fused ``f - A u`` on the location's unknowns: center, zero on the
    ring; face, ``(f - A u) * imask``."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift, imask=imask, needs_mask=True,
               where="solver3d.residual_op") == "ref":
        return ref.residual_op_ref(u, c, f, spacing, loc, shift, imask)
    sd = stagger_dim(loc)
    if sd is not None:
        return residual_face_cuda(u, c, f, imask, sd=sd, h2=_h2(spacing))
    return residual_cuda(u, c, f, h2=_h2(spacing), shift=shift)


def jacobi_sweep(u, c, f, dia, *, omega, spacing, loc: str = "center", shift=None, imask=None,
                 use_kernel: str = "auto"):
    """One fused damped-Jacobi sweep ``u + omega * (f - A u) / dia``
    (stencil + residual + diagonal scale + axpy in one pass; no halo
    update)."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift, imask=imask, needs_mask=True,
               where="solver3d.jacobi_sweep") == "ref":
        return ref.jacobi_sweep_ref(u, c, f, dia, omega=omega, spacing=spacing, loc=loc,
                                    shift=shift, imask=imask)
    sd = stagger_dim(loc)
    if sd is not None:
        return jacobi_face_cuda(u, c, f, dia, imask, sd=sd, omega=omega, h2=_h2(spacing))
    return jacobi_cuda(u, c, f, dia, omega=omega, h2=_h2(spacing), shift=shift)


def cheb_sweep(u, c, f, dia, d, *, a, b, spacing, loc: str = "center", shift=None, imask=None,
               use_kernel: str = "auto"):
    """One fused Chebyshev recurrence step -> ``(u, d)``.

    ``a=None`` is the first step (``d = z / b`` with ``b = theta``; ``d``
    is not read); otherwise ``d = a * d + b * z``.
    """
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift, imask=imask, needs_mask=True,
               where="solver3d.cheb_sweep") == "ref":
        return ref.cheb_sweep_ref(u, c, f, dia, d, a=a, b=b, spacing=spacing, loc=loc,
                                  shift=shift, imask=imask)
    sd = stagger_dim(loc)
    if sd is not None:
        return cheb_face_cuda(u, c, f, dia, imask, d, sd=sd, a=a, b=b, h2=_h2(spacing))
    return cheb_cuda(u, c, f, dia, d, a=a, b=b, h2=_h2(spacing), shift=shift)
