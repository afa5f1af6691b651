"""Public fused solver ops: the CUDA kernels K2-K5 or their plain versions.

Each entry point takes ``use_kernel="auto"|"cuda"|"ref"`` and decides with
:func:`resolve`: ``"auto"`` launches the kernel on a CUDA tensor and runs
the plain version (:mod:`.ref`) on a CPU tensor; whatever the kernel does
not take raises.  This module is the one place where the solvers choose
between the two.  Conventions (those of ``repro_torch.solvers.multigrid``):

* fields are ``(..., nx, ny, nz)`` local blocks INCLUDING the halo ring;
  the caller owns the halo exchange (one ``update_halo`` per sweep);
* diagonals are full-shape and safe to divide (``ref.full_diag``; with a
  shift, the shift is part of the diagonal);
* ``loc`` is ``"center"``: a face location raises ``NotImplementedError``
  (the face variants come with the staggered slice);
* ``shift`` (an optional Helmholtz field) runs on the plain version only:
  where the kernel would run it raises ``NotImplementedError``.
"""

from __future__ import annotations

from .. import dispatch
from . import ref
from .kernel import apply_cuda, cheb_cuda, jacobi_cuda, residual_cuda


def _h2(spacing) -> tuple:
    return tuple(float(s) ** 2 for s in spacing)


def resolve(use_kernel, x, spacing, *, loc: str = "center", shift=None,
            where: str = "solver3d") -> str:
    """``"cuda"`` or ``"ref"`` for a solver op on tensor ``x``; raises for
    what the kernels do not take (a face ``loc``, a ``shift`` or a grid
    that is not 3-D where the kernel would run)."""
    ref.center_only(loc, where)
    if dispatch.resolve(use_kernel, x, where=where) == "ref":
        return "ref"
    if shift is not None:
        raise NotImplementedError(
            f"{where}: the CUDA kernels take no Helmholtz shift yet (it comes with the "
            "two-phase slice); pass use_kernel='ref' for the plain version")
    if len(spacing) != 3:
        raise ValueError(f"{where}: the CUDA kernels are 3-D, got a {len(spacing)}-D grid")
    return "cuda"


def apply_op(u, c, *, spacing, loc: str = "center", shift=None, use_kernel: str = "auto"):
    """Fused ``A u`` on the interior, zero on the ring."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift, where="solver3d.apply_op") == "ref":
        return ref.apply_op_ref(u, c, spacing, shift=shift)
    return apply_cuda(u, c, h2=_h2(spacing))


def residual_op(u, c, f, *, spacing, loc: str = "center", shift=None,
                use_kernel: str = "auto"):
    """Fused ``f - A u`` on the interior, zero on the ring."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift,
               where="solver3d.residual_op") == "ref":
        return ref.residual_op_ref(u, c, f, spacing, shift=shift)
    return residual_cuda(u, c, f, h2=_h2(spacing))


def jacobi_sweep(u, c, f, dia, *, omega, spacing, loc: str = "center", shift=None,
                 use_kernel: str = "auto"):
    """One fused damped-Jacobi sweep ``u + omega * (f - A u) / dia``
    (stencil + residual + diagonal scale + axpy in one pass; no halo
    update)."""
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift,
               where="solver3d.jacobi_sweep") == "ref":
        return ref.jacobi_sweep_ref(u, c, f, dia, omega=omega, spacing=spacing, shift=shift)
    return jacobi_cuda(u, c, f, dia, omega=omega, h2=_h2(spacing))


def cheb_sweep(u, c, f, dia, d, *, a, b, spacing, loc: str = "center", shift=None,
               use_kernel: str = "auto"):
    """One fused Chebyshev recurrence step -> ``(u, d)``.

    ``a=None`` is the first step (``d = z / b`` with ``b = theta``; ``d``
    is not read); otherwise ``d = a * d + b * z``.
    """
    if resolve(use_kernel, u, spacing, loc=loc, shift=shift,
               where="solver3d.cheb_sweep") == "ref":
        return ref.cheb_sweep_ref(u, c, f, dia, d, a=a, b=b, spacing=spacing, shift=shift)
    return cheb_cuda(u, c, f, dia, d, a=a, b=b, h2=_h2(spacing))
