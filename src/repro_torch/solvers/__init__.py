"""Iterative stencil solvers on the implicit global grid, at every
staggering location.

* :mod:`reductions` — exact deduplicated global dots/norms (halo-overlap
  cells masked out; wrap-aware on periodic dims), accumulated in f64;
  several dots as one stacked sum (:func:`tree_dot_many`).
* :func:`cg` — matrix-free (preconditioned) conjugate gradient, classic or
  pipelined, over a field tensor, a ``Field`` or a whole ``FieldSet``; ``project_nullspace="constant"`` for singular all-periodic
  operators; ``dtype=`` for f32 fields with f64 scalars.
* :func:`pseudo_transient` — the accelerated pseudo-transient method.
* :func:`multigrid_solve` — geometric V-cycles with damped-Jacobi or
  Chebyshev smoothing at any location; on a CUDA tensor the operator,
  residual and sweeps are the kernels K2-K5 (center or face);
  :func:`make_tree_v_cycle` for coupled staggered systems.
* :class:`CyclePreconditioner` — the V-cycle as an SPD preconditioner for
  ``cg``, set up once per solve, one cycle per location.
"""

from ..kernels.solver3d.ref import poisson_diag
from . import transfers
from .cg import SolveInfo, cg, cg_local, replacement_count
from .multigrid import (
    SMOOTHERS, build_coefficients, face_diag, face_stencil, level_spacings, make_tree_v_cycle,
    make_v_cycle, multigrid_solve, poisson_apply, prolong_trilinear, restrict_full_weighting,
)
from .preconditioner import CyclePreconditioner
from .pseudo_transient import PTInfo, optimal_parameters, pseudo_transient
from .reductions import (
    acc_dtype, dot, dot_g, field_max, field_max_g, field_min, field_min_g, host_reduce,
    interior_mask, loc_solve_mask, masked_mean, norm_l2, norm_l2_g, norm_linf, norm_linf_g,
    owned_mask, rhs_norm, solve_mask, tree_dot, tree_dot_many, tree_rhs_norm,
)
from .transfers import coarsen_coefficient

__all__ = [
    "acc_dtype", "dot", "norm_l2", "norm_linf", "owned_mask", "interior_mask", "solve_mask",
    "loc_solve_mask", "dot_g", "norm_l2_g", "norm_linf_g", "field_min", "field_max",
    "field_min_g", "field_max_g", "tree_dot", "tree_dot_many", "tree_rhs_norm", "rhs_norm",
    "masked_mean", "host_reduce",
    "cg", "cg_local", "SolveInfo", "replacement_count",
    "pseudo_transient", "PTInfo", "optimal_parameters",
    "multigrid_solve", "poisson_apply", "poisson_diag", "coarsen_coefficient",
    "make_v_cycle", "make_tree_v_cycle", "face_stencil", "face_diag", "build_coefficients",
    "level_spacings", "SMOOTHERS", "restrict_full_weighting", "prolong_trilinear",
    "CyclePreconditioner", "transfers",
]
