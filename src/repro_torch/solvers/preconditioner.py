"""Multigrid cycles as preconditioners for the Krylov solvers.

Instead of iterating V-cycles to tolerance, apply a FIXED small number of
cycles as the preconditioner ``z = M r`` inside
:func:`repro_torch.solvers.cg.cg`: CG picks optimal step sizes and the cycle
only has to contract the error.  ``CyclePreconditioner`` is the ``apply_M``
object form understood by ``cg``: its :meth:`setup` runs once, before the
Krylov loop, building the per-level coefficient hierarchy from the
coefficient operand the operator receives.

SPD-ness (required by CG): with equal pre/post sweeps the cycle is
symmetric (damped Jacobi, or a fixed Chebyshev polynomial in ``D^-1 A``;
``P = 2**nd R^T`` at every location; a fixed number of coarse Jacobi
sweeps), and positive definite when it contracts, which the analytic
smoothing bounds guarantee.

The preconditioner maps each leaf of the residual tree (a tensor, a
``Field`` or a ``FieldSet``) through the cycle built for its location: an
``xface`` Field gets the x-face cycle (staggered operator, vertex transfers
along x, face masks), a center Field or bare tensor the cell-centered
cycle, so each component of a staggered system is smoothed and transferred
on its own grid.  ``per_location=False`` puts the center cycle on every
leaf (the reference's baseline for comparisons).
"""

from __future__ import annotations

import torch

from ..core import locations as _loc
from .multigrid import SMOOTHERS, build_coefficients, level_spacings, make_v_cycle


class CyclePreconditioner:
    """``z = M r`` = ``ncycles`` V-cycle(s) on ``-div(c grad z) = r``.

    Pass as ``cg(..., apply_M=CyclePreconditioner(grid, spacing), ...)``
    with the coefficient field (a tensor or a center ``Field``) as the first
    operator ``args`` entry: ``setup`` receives the operator's operands and
    binds the first as the coefficient.  Cycles are built lazily, one per
    location met, all sharing the one coefficient hierarchy.  Periodic dims
    are inherited from the grid at every level; for the singular
    all-periodic operator pair it with ``cg(..., project_nullspace=
    "constant")``.  ``helmholtz_shift=True`` binds the SECOND operand as a
    cell-centered Helmholtz shift (``args=(c, shift)``, the two-phase
    pressure's ``1/dt + 1/eta``): the cycle then smooths ``shift * z -
    div(c grad z)``, with the shift coarsened like the coefficient.
    ``use_kernel`` selects the CUDA kernels or their plain versions for
    every level.
    """

    def __init__(self, grid, spacing, *, ncycles: int = 1, nu_pre: int = 1, nu_post: int = 1,
                 omega: float = 6.0 / 7.0, coarse_sweeps: int = 50,
                 max_levels: int | None = None, smoother: str = "jacobi",
                 helmholtz_shift: bool = False, per_location: bool = True,
                 use_kernel: str = "auto"):
        if grid.halo != 1:
            raise ValueError("multigrid assumes halo width 1 (overlap=2)")
        if nu_pre != nu_post:
            raise ValueError("CG needs an SPD preconditioner: use nu_pre == nu_post "
                             f"(got {nu_pre} != {nu_post})")
        if smoother not in SMOOTHERS:
            raise ValueError(f"unknown smoother {smoother!r}; pick from {SMOOTHERS}")
        self.grid = grid
        self.grids = grid.hierarchy(max_levels=max_levels)
        if len(self.grids) < 2:
            raise ValueError(f"grid {grid.local_shape} cannot coarsen; multigrid needs >= 2 levels")
        self.hs = level_spacings(grid, self.grids, spacing)
        self.ncycles = int(ncycles)
        self.helmholtz_shift = bool(helmholtz_shift)
        self.per_location = bool(per_location)
        self.kw = dict(nu_pre=nu_pre, nu_post=nu_post, omega=omega,
                       coarse_sweeps=coarse_sweeps, smoother=smoother, use_kernel=use_kernel)

    def setup(self, c, *rest):
        """Build ``M`` from the operator's operands (once per solve)."""
        cs = build_coefficients(self.grid, self.grids, _loc.data_of(c))
        shifts = None
        if self.helmholtz_shift:
            if not rest:
                raise ValueError("helmholtz_shift=True needs the shift field as the second "
                                 "operator arg (args=(c, shift, ...))")
            shifts = build_coefficients(self.grid, self.grids, _loc.data_of(rest[0]))
        cycles: dict = {}

        def cycle_for(loc):
            if loc not in cycles:
                cycles[loc] = make_v_cycle(self.grid, self.grids, self.hs, cs, loc=loc,
                                           shifts=shifts, **self.kw)[0]
            return cycles[loc]

        def one(node):
            v_cycle = cycle_for(_loc.loc_of(node) if self.per_location else "center")
            leaf = _loc.data_of(node)
            e = torch.zeros_like(leaf)
            for _ in range(self.ncycles):
                e = v_cycle(0, e, leaf)
            return node.with_data(e) if _loc.is_field_node(node) else e

        def M(r):
            if _loc.is_field_set(r):
                return type(r)(**{k: one(v) for k, v in r.items()})
            return one(r)

        return M
