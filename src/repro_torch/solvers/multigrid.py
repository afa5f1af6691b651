"""Geometric multigrid (V-cycle) on the implicit global grid, at every
staggering location.

Levels come from :meth:`ImplicitGlobalGrid.hierarchy`: every level keeps
the block counts, periodicity and halo width, so ``update_halo`` works at
every depth; only the local block shrinks (the local interior halves per
level).  Restriction and prolongation (:mod:`.transfers`) are block-local
passes followed by one halo exchange.  ``make_v_cycle(loc=...)`` is
location-generic: on a face location the level operator is
:func:`face_stencil` (center coefficient along the staggered dim,
edge-averaged across), residual, diagonal and transfers are masked by the
location's interior mask at every level, and the transfers are vertex-like
along the staggered dim.  :func:`make_tree_v_cycle` smooths and transfers a
tuple of staggered components coupled by one operator (the full-stress
Stokes velocity block).

The operator is the flux-form variable-coefficient Poisson operator
``A u = -div(c grad u)`` (:func:`poisson_apply`), smoothed by

* ``"jacobi"`` — damped Jacobi (default damping 6/7), or
* ``"chebyshev"`` — the 3-term Chebyshev recurrence on ``D^-1 A`` over
  ``[lam_max/4, lam_max]`` with the Gershgorin bound ``lam_max = 2``: no
  reductions, the residual polynomial stays ``<= 1`` below the interval.

The coarsest level is solved with damped-Jacobi sweeps.  With every dim
periodic and no shift the operator is singular: the coarse rhs is projected
onto mean-zero before the coarse sweeps.

The operator, residual and smoother sweeps of :func:`make_v_cycle` go
through :mod:`repro_torch.kernels.solver3d.ops`, which decides between the
CUDA kernels K2-K5, center or face (a CUDA tensor), and their plain
versions (a CPU tensor, or ``use_kernel="ref"``) at every level, a
Helmholtz shift included (center only); the tree cycle applies the
caller's operator (plain PyTorch, as the reference computes it outside any
kernel).

The V-cycle is exposed two ways: :func:`multigrid_solve` iterates cycles to
tolerance, and :func:`make_v_cycle` builds the cycle as a reusable closure
(e.g. the preconditioner of :func:`repro_torch.solvers.cg.cg`, see
:class:`repro_torch.solvers.preconditioner.CyclePreconditioner`).  Field
tensors are ``(*dims, *local)``; ``update_halo`` writes halo cells in place.
"""

from __future__ import annotations

import time

import torch

from .. import telemetry as tele
from .._device import synchronize
from ..analysis import capture as _cap
from ..analysis import markers as _mk
from ..core import locations as _loc
from ..core.hide import hide_apply
from ..kernels.solver3d import ops
from ..kernels.solver3d.ref import face_diag, face_stencil, full_diag  # noqa: F401
from ..telemetry import health as _health
from ..telemetry.flight import note_solve as _note_solve
from . import reductions as red
from . import transfers
from .cg import SolveInfo, _epilogue, counted

SMOOTHERS = ("jacobi", "chebyshev")


def _inner(nd: int) -> tuple:
    return (Ellipsis,) + (slice(1, -1),) * nd


# ---------------------------------------------------------------------------
# flux-form variable-coefficient Poisson operator
# ---------------------------------------------------------------------------

def poisson_apply(grid, u, c, spacing, update_halo=True, hide=False, shift=None,
                  use_kernel: str = "auto"):
    """``A u = -div(c grad u)`` on the interior, zero on the ring.

    ``c`` is the cell-centered coefficient (halo-consistent); face
    coefficients are arithmetic averages of the two adjacent cells.
    ``shift`` (optional halo-consistent cell-centered field) makes the
    operator Helmholtz-like: ``shift * u - div(c grad u)``, e.g. an implicit
    time step's ``1/dt + 1/eta`` (:mod:`repro_torch.apps.twophase_ops`).
    ``update_halo=True`` refreshes the halo cells of ``u`` in place first.

    ``hide=True`` goes through :func:`repro_torch.core.hide.hide_apply`:
    the same values on every cell, and ``u`` is left as it was (the halo
    update goes into a copy).
    """
    mode = ops.resolve(use_kernel, u, spacing, shift=shift, where="multigrid.poisson_apply")
    if hide:
        if not update_halo:
            raise ValueError("hide=True already includes the halo update")
        if grid.halo != 1:
            raise ValueError("hide=True requires halo width 1 (3-point stencil)")
        if shift is None:
            return hide_apply(grid.topo, lambda uu, cc: ops.apply_op(
                uu, cc, spacing=spacing, use_kernel=mode), u, c, halo=1)
        return hide_apply(grid.topo, lambda uu, cc, ss: ops.apply_op(
            uu, cc, spacing=spacing, shift=ss, use_kernel=mode), u, c, shift, halo=1)
    if update_halo:
        grid.update_halo(u)
    return ops.apply_op(u, c, spacing=spacing, shift=shift, use_kernel=mode)


# ---------------------------------------------------------------------------
# the reference's center-only names of the grid transfers (public aliases of
# transfers.restrict / transfers.prolong at cell centers)
# ---------------------------------------------------------------------------

def restrict_full_weighting(fine):
    """Center restriction (see :func:`repro_torch.solvers.transfers.restrict`)."""
    return transfers.restrict(fine, "center")


def prolong_trilinear(coarse):
    """Center prolongation (see :func:`repro_torch.solvers.transfers.prolong`)."""
    return transfers.prolong(coarse, "center")


# ---------------------------------------------------------------------------
# V-cycle construction (shared by the solver and the CG preconditioner)
# ---------------------------------------------------------------------------

def level_spacings(grid, grids, spacing):
    """Per-level grid spacings from each level's true global node count:
    ``(N_fine - 1) / (N_coarse - 1)`` per Dirichlet dim (the ring nodes do
    not coarsen), exactly 2 per periodic dim."""
    spacing = tuple(float(s) for s in spacing)
    lengths = [grid.span(d) * h for d, h in enumerate(spacing)]
    return [tuple(L / g.span(d) for d, L in enumerate(lengths)) for g in grids]


def build_coefficients(grid, grids, c):
    """Per-level halo-consistent coefficient fields (``c`` is not
    modified: its halo is refreshed on a copy)."""
    nd = grid.ndims
    cs = [grid.update_halo(c.clone())]
    for _ in grids[1:]:
        cs.append(grid.update_halo(transfers.coarsen_coefficient(cs[-1], nd)))
    return cs


# Chebyshev smoothing interval on D^-1 A: Gershgorin gives lam_max = 2 for
# the flux-form operator; the standard upper-spectrum target [b/4, b].
_CHEB_UPPER = 2.0
_CHEB_RATIO = 4.0


def _cheb_rhos(degree: int, upper: float = _CHEB_UPPER,
               ratio: float = _CHEB_RATIO) -> tuple[float, float, list[float]]:
    """(theta, delta, [rho_1..rho_degree]) of the 3-term recurrence."""
    a, b = upper / ratio, upper
    theta, delta = (b + a) / 2.0, (b - a) / 2.0
    sigma1 = theta / delta
    rhos = [1.0 / sigma1]
    for _ in range(degree - 1):
        rhos.append(1.0 / (2.0 * sigma1 - rhos[-1]))
    return theta, delta, rhos


def make_v_cycle(grid, grids, hs, cs, *, loc: str = "center", shifts=None, nu_pre: int = 2,
                 nu_post: int = 2, omega: float = 6.0 / 7.0, coarse_sweeps: int = 100,
                 smoother: str = "jacobi", use_kernel: str = "auto"):
    """Build ``(v_cycle, residual)`` closures over a hierarchy.

    ``grids``/``hs``/``cs`` are the per-level grids, spacings
    (:func:`level_spacings`) and halo-consistent CENTER coefficients
    (:func:`build_coefficients`; one coefficient hierarchy serves every
    location).  ``v_cycle(level, u, f)`` takes a halo-consistent iterate
    and a rhs that is zero outside the location's unknowns;
    ``residual(level, u, f)`` is ``f - A u``, zero outside the unknowns.

    ``loc`` makes the whole cycle location-generic: on a face location the
    level operator is :func:`face_stencil`, the smoother diagonal, residual
    and transfers are masked by the location's interior mask (pinned
    boundary faces and the dead plane stay zero at every level), and the
    transfers are the per-location pairs of :mod:`.transfers`.

    ``shifts`` (optional per-level halo-consistent fields ``s >= 0``, center
    only) make the operator Helmholtz-like and join the smoother diagonal;
    the kernels take them as they are, the diagonal already shifted.
    ``smoother`` selects damped Jacobi or Chebyshev for the pre/post sweeps
    (``nu_pre``/``nu_post`` = sweeps resp. polynomial degree); the coarsest
    level always uses ``coarse_sweeps`` Jacobi sweeps.  On a CUDA tensor
    every level's residual and sweeps are the kernels K3-K5 of ``loc``; the
    choice is made once, here, for every level.
    """
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown smoother {smoother!r}; pick from {SMOOTHERS}")
    sd = _loc.stagger_dim(loc)
    if sd is not None and shifts is not None:
        raise ValueError(f"Helmholtz shifts are only supported for the center cycle "
                         f"(got loc={loc!r})")
    nd = grid.ndims
    inner = _inner(nd)
    mode = ops.resolve(use_kernel, cs[0], hs[0], loc=loc, shift=shifts,
                       where="multigrid.v_cycle")
    singular = shifts is None and all(grid.topo.periodic)
    shifts = [None] * len(grids) if shifts is None else shifts

    if sd is None:
        imasks = [None] * len(grids)
        # full-shape, safe-to-divide diagonals (ones on the ring)
        dias = [full_diag(ck, hk) for ck, hk in zip(cs, hs)]
        for dk, sk in zip(dias, shifts):
            if sk is not None:
                dk[inner] += sk[inner]
    else:
        # the unknowns of loc at every level; dia * m + (1 - m) is safe to divide
        imasks = [_loc.interior_mask(g, loc, ck.dtype) for g, ck in zip(grids, cs)]
        dias = [full_diag(ck, hk, loc, mk) for ck, hk, mk in zip(cs, hs, imasks)]

    def _demean(level, f):
        g = grids[level]
        mean = red.masked_mean(g, f, red.loc_solve_mask(g, loc, f.dtype))
        return f - mean.to(f.dtype)

    def residual(level, u, f):
        """f - A u on the unknowns of ``loc``, zero elsewhere (u halo-consistent)."""
        return ops.residual_op(u, cs[level], f, spacing=hs[level], loc=loc, shift=shifts[level],
                               imask=imasks[level], use_kernel=mode)

    def jacobi(level, u, f, iters):
        for _ in range(iters):
            u = ops.jacobi_sweep(u, cs[level], f, dias[level], omega=omega, spacing=hs[level],
                                 loc=loc, shift=shifts[level], imask=imasks[level],
                                 use_kernel=mode)
            grid.update_halo(u)
        return u

    def chebyshev(level, u, f, degree):
        # 3-term recurrence on D^-1 A over [lam_max/4, lam_max]; the rho_k
        # are analytic constants: no reductions.
        theta, delta, rhos = _cheb_rhos(degree)
        d = None
        for k in range(degree):
            a = None if k == 0 else rhos[k] * rhos[k - 1]
            b = theta if k == 0 else 2.0 * rhos[k] / delta
            u, d = ops.cheb_sweep(u, cs[level], f, dias[level], d, a=a, b=b, spacing=hs[level],
                                  loc=loc, shift=shifts[level], imask=imasks[level],
                                  use_kernel=mode)
            grid.update_halo(u)
        return u

    smooth = jacobi if smoother == "jacobi" else chebyshev

    def restrict_to(level, r):
        fc = transfers.restrict(r, loc, nd)
        return fc if sd is None else fc * imasks[level]

    def prolong_to(level, ec):
        e = transfers.prolong(ec, loc, nd)
        return e if sd is None else e * imasks[level]

    def v_cycle(level, u, f):
        if level == len(grids) - 1:
            if singular:
                f = _demean(level, f)
            return jacobi(level, u, f, coarse_sweeps)
        u = smooth(level, u, f, nu_pre)
        r = grid.update_halo(residual(level, u, f))
        fc = grid.update_halo(restrict_to(level + 1, r))
        ec = v_cycle(level + 1, torch.zeros(grids[level + 1].shape, dtype=u.dtype,
                                            device=u.device), fc)
        e = grid.update_halo(prolong_to(level, ec))
        return smooth(level, u + e, f, nu_post)

    return v_cycle, residual


def make_tree_v_cycle(grid, grids, locs, apply_level, diag_level, *, nu_pre: int = 1,
                      nu_post: int = 1, omega: float = 0.6, coarse_sweeps: int = 50,
                      smoother: str = "jacobi", cheb_upper: float = 3.0):
    """V-cycle over a TUPLE of staggered components coupled by ONE operator.

    For systems whose components couple through the operator (the
    full-stress Stokes velocity block, where the shear ties ``vx``/``vy``/
    ``vz`` together) the cycle smooths and transfers the whole tuple, each
    leaf on its own staggered grid:

    * ``locs`` — per-leaf locations (e.g. ``("xface", "yface", "zface")``),
      fixing each leaf's transfers and interior masks at every level;
    * ``apply_level(level, u_tuple) -> tuple`` — the coupled operator on
      halo-consistent leaves, raw and unmasked (the cycle masks);
    * ``diag_level(level) -> tuple`` — full-shape positive per-leaf
      diagonals of that operator.

    Smoothing is damped block-pointwise Jacobi or the 3-term Chebyshev
    recurrence on ``D^-1 A`` with the Gershgorin bound ``cheb_upper`` (3 for
    the full-stress block; the default damping ``omega = 0.6 < 2/3``
    accordingly).  One halo exchange of all leaves per sweep and transfer;
    restriction and prolongation are per leaf, so ``P = 2**nd R^T`` holds
    leaf-wise and the cycle with ``nu_pre == nu_post`` is a symmetric
    preconditioner for CG over the same FieldSet.  Plain PyTorch throughout,
    as the reference computes it outside any kernel.

    Returns ``(v_cycle, residual)``; both take and return tuples of field
    tensors.
    """
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown smoother {smoother!r}; pick from {SMOOTHERS}")
    locs = tuple(locs)
    nd = grid.ndims
    imasks = [tuple(_loc.interior_mask(g, loc, grid.dtype) for loc in locs) for g in grids]
    dias = [tuple(dk * mk + (1.0 - mk) for dk, mk in zip(diag_level(level), imasks[level]))
            for level in range(len(grids))]

    def _halo(u):
        out = grid.update_halo(*u)
        return out if isinstance(out, tuple) else (out,)

    def residual(level, u, f):
        """f - A u on each leaf's unknowns, zero elsewhere."""
        Au = apply_level(level, u)
        return tuple((fi - ai) * mi for fi, ai, mi in zip(f, Au, imasks[level]))

    def jacobi(level, u, f, iters):
        for _ in range(iters):
            r = residual(level, u, f)
            u = _halo(tuple(ui + omega * ri / di for ui, ri, di in zip(u, r, dias[level])))
        return u

    def chebyshev(level, u, f, degree):
        theta, delta, rhos = _cheb_rhos(degree, upper=cheb_upper)
        z = tuple(ri / di for ri, di in zip(residual(level, u, f), dias[level]))
        d = tuple(zi / theta for zi in z)
        u = _halo(tuple(ui + di for ui, di in zip(u, d)))
        for k in range(1, degree):
            z = tuple(ri / di for ri, di in zip(residual(level, u, f), dias[level]))
            d = tuple((rhos[k] * rhos[k - 1]) * di + (2.0 * rhos[k] / delta) * zi
                      for di, zi in zip(d, z))
            u = _halo(tuple(ui + di for ui, di in zip(u, d)))
        return u

    smooth = jacobi if smoother == "jacobi" else chebyshev

    def v_cycle(level, u, f):
        if level == len(grids) - 1:
            return jacobi(level, u, f, coarse_sweeps)
        u = smooth(level, u, f, nu_pre)
        r = _halo(residual(level, u, f))
        fc = _halo(tuple(transfers.restrict(ri, loc, nd) * mi
                         for ri, loc, mi in zip(r, locs, imasks[level + 1])))
        zeros = tuple(torch.zeros(grids[level + 1].shape, dtype=ui.dtype, device=ui.device)
                      for ui in u)
        ec = v_cycle(level + 1, zeros, fc)
        e = _halo(tuple(transfers.prolong(eci, loc, nd) * mi
                        for eci, loc, mi in zip(ec, locs, imasks[level])))
        return smooth(level, tuple(ui + ei for ui, ei in zip(u, e)), f, nu_post)

    return v_cycle, residual


# ---------------------------------------------------------------------------
# V-cycle solver
# ---------------------------------------------------------------------------

def multigrid_solve(grid, c, b, spacing, x0=None, *, loc: str | None = None, tol: float = 1e-6,
                    maxiter: int = 100, nu_pre: int = 2, nu_post: int = 2,
                    omega: float = 6.0 / 7.0, coarse_sweeps: int = 100,
                    max_levels: int | None = None, smoother: str = "jacobi",
                    use_kernel: str = "auto"):
    """Solve ``-div(c grad x) = b`` by V-cycles, at any staggering location.

    ``b``/``x0`` may be center tensors or ``repro_torch.fields.Field``s at
    any location: a face-located ``b`` gets the staggered cycle of
    ``make_v_cycle(loc=...)`` and a Field of the same location back.
    ``loc`` names the location of bare tensors; ``c`` is always the CENTER
    coefficient (a Field or a tensor).

    Homogeneous Dirichlet on non-periodic dims (the ring holds the BC; for
    the staggered dim of a face field the pinned planes are the boundary
    faces and the dead plane), wraparound on periodic dims.  With EVERY dim periodic the operator is
    singular; the rhs is projected onto mean-zero and the mean-zero
    representative is returned.  Convergence is the deduplicated global
    relative residual on the fine level, read on the host once per cycle
    (the health probes of :func:`repro_torch.telemetry.watch` classify that
    same float).  Returns ``(x, SolveInfo)``.
    """
    if grid.halo != 1:
        raise ValueError("multigrid assumes halo width 1 (overlap=2)")
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown smoother {smoother!r}; pick from {SMOOTHERS}")
    if _cap.capturing():   # an analyzer capture: record this solve, run nothing
        _cap.maybe_capture("mg", grid, (b, c, x0), lambda: multigrid_solve(
            grid, c, b, spacing, x0, loc=loc, tol=tol, maxiter=maxiter, nu_pre=nu_pre,
            nu_post=nu_post, omega=omega, coarse_sweeps=coarse_sweeps, max_levels=max_levels,
            smoother=smoother, use_kernel=use_kernel))
    loc = _loc.loc_of(b) if loc is None else loc
    wrap = b.with_data if _loc.is_field_node(b) else None
    b, c = _loc.data_of(b), _loc.data_of(c)
    x0 = None if x0 is None else _loc.data_of(x0)
    grids = grid.hierarchy(max_levels=max_levels)
    if len(grids) < 2:
        raise ValueError(f"grid {grid.local_shape} cannot coarsen; multigrid needs >= 2 levels")
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    hs = level_spacings(grid, grids, spacing)
    singular = all(grid.topo.periodic)

    cfg = _health.current()
    t0 = time.perf_counter()
    with counted() as col:
        cs = build_coefficients(grid, grids, c)
        v_cycle, residual = make_v_cycle(
            grid, grids, hs, cs, loc=loc, nu_pre=nu_pre, nu_post=nu_post, omega=omega,
            coarse_sweeps=coarse_sweeps, smoother=smoother, use_kernel=use_kernel)
        mask = red.loc_solve_mask(grid, loc, b.dtype)

        def demean(a):
            return a - red.masked_mean(grid, a, mask).to(a.dtype)

        if singular:
            b = demean(b)
        bnorm = red.rhs_norm(grid, b, mask)
        bnormf = _mk.host(bnorm)
        grid.update_halo(x)
        r = residual(0, x, b)
        res = torch.sqrt(red.dot(grid, r, r, mask))
        # the one host read of each cycle's test
        resf = _mk.loop_float(res, site="solvers.multigrid_solve", first=True)
        probe = None if cfg is None else _health.Probe(cfg, "mg", resf, bnormf,
                                                       ranks=grid.topo.block_ranks())
        hist, k, ok = [], 0, True
        while k < maxiter and resf > tol * bnormf and ok:
            with tele.tag("iteration"):
                x = v_cycle(0, x, b)
                r = residual(0, x, b)
                res = torch.sqrt(red.dot(grid, r, r, mask))
                hist.append(res / bnorm)
            k += 1
            resf = _mk.loop_float(res, site="solvers.multigrid_solve")
            if probe is not None:
                ok = probe.step(k, resf)
        if singular:
            x = grid.update_halo(demean(x))
    if _mk.TRACE is not None:   # a capture stops before the host reads
        return x, None
    hist = torch.stack(hist) if hist else torch.zeros(0, dtype=torch.float64)
    relres, residuals, dstatus = _epilogue(probe, k, res / bnorm, hist, tol, maxiter)
    synchronize(x)
    wall = time.perf_counter() - t0
    if wrap is not None:
        x = wrap(x)
    info = SolveInfo(iterations=k, relres=relres, converged=relres <= tol,
                     residuals=residuals, wall_s=wall,
                     comm=None if col is None else col.stats(),
                     status=_health.classify(dstatus, relres, tol, k, maxiter))
    _note_solve("mg", info)
    return x, info
