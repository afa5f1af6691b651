"""Matrix-free conjugate gradient on the implicit global grid.

The operator is any local-view stencil, typically a halo-updating wrapper
such as :func:`repro_torch.solvers.multigrid.poisson_apply`; CG never sees
the matrix.  Dot products are the deduplicated masked reductions of
:mod:`.reductions` (f64 accumulators), so the result is that of a
single-block solve of the global system.

The unknown vector is a *tree*: a field tensor (scalar problems), a
``repro_torch.fields.Field``, or a whole staggered system (a ``FieldSet``,
e.g. the three face-located Stokes velocity components), with
location-aware reduction and unknown masks per leaf; every dot over the
tree is one reduction.  ``apply_A`` maps the tree to the same structure.

Two Krylov schedules (``variant=``):

* ``"classic"`` — textbook preconditioned CG: ``<p, Ap>``, then ``<r, z>``
  and ``||r||^2`` as one stacked reduction.
* ``"pipelined"`` — Ghysels–Vanroose pipelined CG: one stacked reduction
  per iteration carrying ``<r, u>``, ``<w, u>`` and ``||r||^2``, issued
  before the iteration's preconditioner and operator applies; every
  ``replace_every`` iterations the residual and its auxiliaries are
  recomputed exactly (``r = b - A x``).  The stopping test is one
  iteration stale, so it runs one iteration more than classic CG.

The loop runs in Python.  Every scalar (``alpha``, ``beta``, the dots) stays
a 0-d tensor on the device; the only host read per iteration is the f64
residual norm for the stopping test, so iteration counts equal the
reference's ``lax.while_loop`` on the same inputs.  That read goes through
:func:`repro_torch.analysis.markers.loop_float`, which an analyzer capture
(:mod:`repro_torch.analysis.capture`) uses to run the loop body without
reading anything.  Under
:func:`repro_torch.telemetry.watch` the health probes classify that same
float (no further read); while a telemetry session is active the solve
is counted (:mod:`repro_torch.telemetry.counters`), its loop bodies
tagged ``"iteration"`` / ``"replacement"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from .. import telemetry as tele
from .._device import synchronize
from ..analysis import capture as _cap
from ..analysis import markers as _mk
from ..core import locations as _loc
from ..telemetry import health as _health
from ..telemetry.flight import note_solve as _note_solve
from . import reductions as red

VARIANTS = ("classic", "pipelined")


@dataclasses.dataclass
class SolveInfo:
    """Outcome of an iterative solve.

    ``residuals[j]`` is the relative residual after iteration ``j + 1``
    (for ``variant="pipelined"`` the one entering iteration ``j + 1``);
    its last entry equals ``relres``.  ``wall_s`` is the host time of the
    solve, synchronised on the result.  ``replacements`` counts the
    residual-replacement segments a pipelined solve ran, for
    ``comm.totals(iterations, replacements)``.  ``comm`` (set while a
    :mod:`repro_torch.telemetry` session is active) is the solve's
    communication split: halo exchanges and bytes per dim and all-reduce
    counts, setup vs per iteration vs per replacement, counted on the live
    solve.  ``status`` is the typed
    :class:`repro_torch.telemetry.SolveStatus` outcome — always classified
    from the final scalars; under :func:`repro_torch.telemetry.watch` the
    probes refine it with stagnation/divergence detection and early exit.
    """

    iterations: int
    relres: float
    converged: bool
    residuals: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    wall_s: float | None = None
    comm: "tele.CommStats | None" = None
    status: "tele.SolveStatus | None" = None
    replacements: int = 0

    def s_per_iter(self) -> float:
        """Wall seconds per iteration (NaN before timing is recorded)."""
        if self.wall_s is None or self.iterations <= 0:
            return float("nan")
        return self.wall_s / self.iterations


_tmap = _loc.tree_map


def _mask_trees(grid, tree):
    """(reduction masks, unknown masks) matching ``tree``'s structure: Fields
    get their location's masks (as Fields), bare tensors the center masks."""
    def solve(a):
        if _loc.is_field_node(a):
            return a.with_data(red.loc_solve_mask(grid, a.loc, a.dtype))
        return red.solve_mask(grid, a.dtype)

    def unknown(a):
        if _loc.is_field_node(a):
            return a.with_data(_loc.interior_mask(grid, a.loc, a.dtype))
        return red.interior_mask(grid, dtype=a.dtype)

    return _loc.node_map(solve, tree), _loc.node_map(unknown, tree)


def replacement_count(iterations: int, replace_every: int) -> int:
    """Residual-replacement segments a pipelined solve of ``iterations``
    ran: one per started segment of ``replace_every`` iterations."""
    return math.ceil(int(iterations) / max(int(replace_every), 1))


def cg_local(grid, apply_A: Callable, b, x, *, tol: float = 1e-6, maxiter: int = 1000,
             apply_M: Callable | None = None, project_nullspace: str | None = None,
             variant: str = "classic", replace_every: int = 50, cfg=None, name: str = "cg"):
    """The Krylov loop on trees ``b``/``x`` with one-argument callables
    ``apply_A``/``apply_M`` (preconditioner setup already bound).

    Returns ``(x, k, relres, hist)``: the halo-fresh iterate, the iteration
    count, the final relative residual (0-d tensor) and the history (1-D
    f64 tensor).  ``x`` is updated out of place, except that the operator's
    halo update writes its halo cells.  With a
    :class:`repro_torch.telemetry.HealthConfig` ``cfg`` the loop is watched
    (probes on the residual it reads, heartbeats under the solver ``name``)
    and its :class:`repro_torch.telemetry.health.Probe` is returned fifth:
    ``probe.finish(...)`` on the host values of ``relres`` and ``hist``
    gives the terminal :class:`~repro_torch.telemetry.SolveStatus` and the
    final-health events, with no device work of its own.
    """
    red_masks, unk_masks = _mask_trees(grid, b)

    def mdot(u, v):
        return red.tree_dot(grid, u, v, red_masks)

    def mdots(*pairs):
        return red.tree_dot_many(grid, pairs, red_masks)

    def masked(t):
        return _tmap(lambda a, m: a * m, t, unk_masks)

    if project_nullspace == "constant":
        def project(t):
            # each leaf carries its own constant mode: subtract its masked
            # mean on the unknowns only (a Dirichlet ring keeps its BC data)
            return _tmap(lambda a, mr, mu: a - red.masked_mean(grid, a, mr).to(a.dtype) * mu,
                         t, red_masks, unk_masks)

        b = project(b)
    else:
        def project(t):
            return t

    bnorm = red.tree_rhs_norm(grid, b, red_masks)
    bnormf = _mk.host(bnorm)
    # the health probe of a watched loop, made from its first residual
    watch = None if cfg is None else (lambda res0: _health.Probe(
        cfg, name, res0, bnormf, ranks=grid.topo.block_ranks()))
    common = dict(maxiter=maxiter, project=project, masked=masked, mdot=mdot, mdots=mdots,
                  bnorm=bnorm, watch=watch)
    if variant == "classic":
        x, res, k, hist, probe = _classic_loop(apply_A, apply_M, b, x, tol * bnormf, **common)
    else:
        x, res, k, hist, probe = _pipelined_loop(apply_A, apply_M, b, x, tol * bnormf,
                                                 replace_every=replace_every, **common)
    # the mean-zero representative of a singular solve, halo-fresh
    x = _tmap(grid.update_halo, project(x))
    if _mk.TRACE is not None:
        # callers that feed x straight into a halo-updating operator (a
        # warm start) legitimately re-exchange it: an analyzer contract
        x = _tmap(lambda a: _mk.exchange_out(a, width=grid.halo, site="solvers.cg.tail.contract",
                                             contract=True), x)
    hist = torch.stack(hist) if hist else torch.zeros(0, dtype=torch.float64)
    if cfg is None:
        return x, k, res / bnorm, hist
    return x, k, res / bnorm, hist, probe


def _epilogue(probe, k: int, relres, hist, tol: float, maxiter: int):
    """The host values every solve ends with — the relative residual and the
    history, read once — and, for a watched solve, its terminal status and
    final-health events (one per block this process holds) from those same
    values.
    Returns ``(relres, residuals, device_status)``."""
    relres = float(relres)
    residuals = hist.cpu().numpy()
    if probe is None:
        return relres, residuals, None
    return relres, residuals, probe.finish(k, relres, residuals, tol, maxiter)


def _classic_loop(apply_A, M, b, x, thresh, *, maxiter, project, masked, mdot, mdots, bnorm,
                  watch):
    """Textbook preconditioned CG.  Returns ``(x, res, k, hist, probe)``."""
    r = masked(_tmap(torch.sub, b, apply_A(x)))
    z = project(masked(M(r))) if M is not None else project(r)
    p = z
    rz = mdot(r, z)
    res = torch.sqrt(mdot(r, r))
    # the one host read of each iteration's test
    resf = _mk.loop_float(res, site="solvers.cg", first=True)
    probe = None if watch is None else watch(resf)
    hist, k, ok = [], 0, True
    while k < maxiter and resf > thresh and ok:
        with tele.tag("iteration"):
            Ap = masked(apply_A(p))
            alpha = rz / mdot(p, Ap)
            x = _tmap(lambda xi, pi: xi + alpha.to(xi.dtype) * pi, x, p)
            r = _tmap(lambda ri, ai: ri - alpha.to(ri.dtype) * ai, r, Ap)
            if M is not None:
                z = project(masked(M(r)))
                rz_new, rr = mdots((r, z), (r, r))   # one stacked reduction
                res = torch.sqrt(rr)
            else:
                z = project(r)
                rz_new = mdot(r, z)   # unpreconditioned: <r, z> is ||r||^2
                res = torch.sqrt(rz_new)
            beta = rz_new / rz
            p = _tmap(lambda zi, pi: zi + beta.to(zi.dtype) * pi, z, p)
            rz = rz_new
            hist.append(res / bnorm)
        k += 1
        resf = _mk.loop_float(res, site="solvers.cg")
        if probe is not None:
            ok = probe.step(k, resf)
    return x, res, k, hist, probe


def _pipelined_loop(apply_A, M, b, x, thresh, *, maxiter, replace_every, project, masked,
                    mdot, mdots, bnorm, watch):
    """Ghysels–Vanroose pipelined CG with residual replacement at each
    segment head (the k = 0 head doubles as the setup).  Returns
    ``(x, res, k, hist, probe)``."""
    if replace_every is None or int(replace_every) <= 0:
        replace_every = maxiter
    replace_every = int(replace_every)

    def prec(t):
        # segment heads: the nullspace projection runs here only
        return project(masked(M(t))) if M is not None else project(t)

    def precit(t):
        # per iteration: no projection, keeping the single reduction
        return masked(M(t)) if M is not None else t

    def axpy(add, a, ti, tj):
        # ti + a * tj (add) or ti - a * tj, the f64 scalar cast per leaf
        s = (1.0 if add else -1.0) * a
        return _tmap(lambda u, v: u + s.to(u.dtype) * v, ti, tj)

    r0 = masked(_tmap(torch.sub, b, apply_A(x)))
    res = torch.sqrt(mdot(r0, r0))
    # the one host read of each iteration's test
    resf = _mk.loop_float(res, site="solvers.cg.pipelined", first=True)
    probe = None if watch is None else watch(resf)
    p = _tmap(torch.zeros_like, b)
    gp = ap = torch.ones((), dtype=res.dtype, device=res.device)
    hist, k, ok = [], 0, True
    while k < maxiter and resf > thresh and ok:
        with tele.tag("replacement"):
            # exact recomputation of the residual chain and of the search
            # direction's auxiliaries (s = A p, q = M s, z = A q)
            r = masked(_tmap(torch.sub, b, apply_A(x)))
            u = prec(r)
            w = masked(apply_A(u))
            s = masked(apply_A(p))
            q = prec(s)
            z = masked(apply_A(q))
        limit = min(k + replace_every, maxiter)
        while k < limit and resf > thresh and ok:
            with tele.tag("iteration"):
                gamma, delta, rr = mdots((r, u), (w, u), (r, r))
                m = precit(w)
                n = masked(apply_A(m))
                res = torch.sqrt(rr)
                beta = gamma / gp if k > 0 else torch.zeros_like(gamma)
                alpha = gamma / (delta - beta * gamma / ap)
                z = axpy(True, beta, n, z)
                q = axpy(True, beta, m, q)
                s = axpy(True, beta, w, s)
                p = axpy(True, beta, u, p)
                x = axpy(True, alpha, x, p)
                r = axpy(False, alpha, r, s)
                u = axpy(False, alpha, u, q)
                w = axpy(False, alpha, w, z)
                hist.append(res / bnorm)
                gp, ap = gamma, alpha
            k += 1
            resf = _mk.loop_float(res, site="solvers.cg.pipelined")
            if probe is not None:
                ok = probe.step(k, resf)
    return x, res, k, hist, probe


def cg(grid, apply_A: Callable, b, x0=None, *, tol: float = 1e-6, maxiter: int = 1000,
       apply_M=None, project_nullspace: str | None = None, dtype=None, args=(),
       variant: str = "classic", replace_every: int = 50):
    """Solve ``A x = b`` with (preconditioned) conjugate gradient.

    ``apply_A(u, *args)`` is a local-view operator on a tree of fields (a
    tensor, a Field or a FieldSet); it must zero the physical boundary ring
    (per-location boundary faces for staggered leaves) so Dirichlet cells
    stay fixed (on periodic dims its halo exchange maintains the ring
    duplicates).  ``args`` are extra fields passed to the operator (e.g.
    the coefficient).

    ``apply_M`` is an optional SPD preconditioner ``z = M r``: a function of
    the residual, or an object with ``setup(*args) -> M`` (e.g.
    :class:`repro_torch.solvers.preconditioner.CyclePreconditioner`), whose
    setup runs once before the Krylov loop.

    ``project_nullspace="constant"`` removes the constant mode from the
    rhs, the preconditioned residual and the returned iterate (required for
    the singular all-periodic operator; the pipelined variant projects at
    segment heads only).  ``dtype`` casts ``b``, ``x0`` and ``args`` before
    the solve, leaf by leaf (e.g. ``torch.float32``: f32 fields, f64
    scalars).  Returns ``(x, SolveInfo)``.
    """
    if project_nullspace not in (None, "constant"):
        raise ValueError(f"unknown project_nullspace {project_nullspace!r}; "
                         "expected None or 'constant'")
    if variant not in VARIANTS:
        raise ValueError(f"unknown cg variant {variant!r}; expected one of {VARIANTS}")
    if _cap.capturing():   # an analyzer capture: record this solve, run nothing
        _cap.maybe_capture("cg", grid, (b, x0, *args), lambda: cg(
            grid, apply_A, b, x0, tol=tol, maxiter=maxiter, apply_M=apply_M,
            project_nullspace=project_nullspace, dtype=dtype, args=args, variant=variant,
            replace_every=replace_every))
    if dtype is not None:
        def cast(t):
            return _tmap(lambda a: a.to(dtype), t)

        b = cast(b)
        args = tuple(cast(a) for a in args)
        x0 = None if x0 is None else cast(x0)
    x = _tmap(torch.zeros_like if x0 is None else torch.clone, b if x0 is None else x0)
    cfg = _health.current()
    t0 = time.perf_counter()
    with counted() as col:
        M = apply_M.setup(*args) if hasattr(apply_M, "setup") else apply_M
        outs = cg_local(
            grid, lambda u: apply_A(u, *args), b, x, tol=tol, maxiter=maxiter, apply_M=M,
            project_nullspace=project_nullspace, variant=variant, replace_every=replace_every,
            cfg=cfg)
    if _mk.TRACE is not None:   # a capture stops before the host reads
        return outs[0], None
    x, k, relres, hist = outs[:4]
    probe = None if cfg is None else outs[4]
    relres, residuals, dstatus = _epilogue(probe, k, relres, hist, tol, maxiter)
    synchronize(_loc.tree_leaves(x)[0])
    wall = time.perf_counter() - t0
    status = _health.classify(dstatus, relres, tol, k, maxiter)
    nrep = replacement_count(k, replace_every) if variant == "pipelined" else 0
    info = SolveInfo(iterations=k, relres=relres, converged=relres <= tol,
                     residuals=residuals, wall_s=wall,
                     comm=None if col is None else col.stats(), status=status,
                     replacements=nrep)
    _note_solve("cg", info)
    return x, info


@contextlib.contextmanager
def counted():
    """A live comm collector around a solve while a telemetry session is
    active (yields None otherwise: nothing is counted)."""
    if not tele.enabled():
        yield None
        return
    with tele.counting() as col:
        yield col
