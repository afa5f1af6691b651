"""3-D variable-viscosity Stokes flow on the staggered grid — the flagship.

    -div( 2 eta D(V) ) + grad P = F      (momentum, faces)
                          div V = 0      (continuity, centers)

with the full symmetric-gradient stress ``D(V) = (grad V + grad V^T)/2`` on
the MAC staggering of :mod:`repro_torch.fields`: ``vx``/``vy``/``vz`` on
x/y/z-faces, pressure and viscosity at centers, viscosity averaged onto
edges for the shear stresses, which couple the components
(``stress="stripped"`` keeps the decoupled per-component block).  Boundary
conditions per non-periodic dim: ``bc="noslip"`` (zero on every boundary
face) or ``bc="freeslip"`` (normal component pinned, tangential components
stress-free through a zero-flux ghost ring).  The pressure's constant mode
is removed by a mean-zero projection over its unknowns.

Solution strategy (the reference's):

* the velocity block ``A`` is solved by :func:`repro_torch.solvers.cg` with
  the whole staggered system as one Krylov vector (a ``FieldSet``),
  preconditioned by staggered multigrid: ``precond="stress"`` is the
  coupled tree V-cycle of :func:`~repro_torch.solvers.multigrid.
  make_tree_v_cycle` on the operator itself, ``"face"`` the per-leaf face
  cycles (kernels K3-K5 face on a CUDA tensor), ``"center"`` the
  cell-centered cycle on every leaf, ``None`` none;
* the pressure solves the viscosity-preconditioned Schur complement
  ``(-div A^-1 grad) P = -div A^-1 F`` by outer CG, each matvec one
  velocity solve, preconditioned by ``z = eta r``; ``method="uzawa"`` keeps
  the Richardson step ``P <- P - theta eta div V``.

The operator's arithmetic is :mod:`repro_torch.stencil.mac` (the NumPy
oracle uses the same spelling with ``xp = numpy``); the stripped block is
kernel K2 face per component on a CUDA tensor (its plain version is that
same spelling).  The oracle's ghost filling, coupled CG and Uzawa loop on
the gathered global arrays stay independent.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import fields, solvers
from ..analysis import capture as _cap
from ..analysis import markers as _mk
from ..core import boundary, init_global_grid
from ..fields import Field, FieldSet, ops
from ..kernels.solver3d import ops as kops
from ..solvers import reductions as red
from ..solvers.multigrid import build_coefficients, level_spacings, make_tree_v_cycle
from .. import telemetry as tele
from ..telemetry import a_eff, t_eff
from . import _stencil_np as stn

_COMPONENTS = ("vx", "vy", "vz")
_FACE_LOCS = ("xface", "yface", "zface")
STRESSES = ("full", "stripped")
BCS = ("noslip", "freeslip")


@dataclasses.dataclass
class StokesInfo:
    """Outcome of a Stokes solve (host-side scalars)."""

    outer_iterations: int
    inner_iterations: int      # total CG iterations across velocity solves
    first_inner_iterations: int
    relres_momentum: float
    relres_div: float          # final ||div V|| / initial ||div V||
    converged: bool


def viscous_apply(stress: str, V, eta, spacing, use_kernel: str = "auto") -> list:
    """The raw (unmasked) velocity block on the component tensors ``V``:
    the eager full-stress operator, or the stripped one as kernel K2 face
    per component (its plain version on a CPU tensor)."""
    if stress == "full":
        return stn.full_stress_apply(torch, V, eta, spacing)
    return [kops.apply_op(v, eta, spacing=spacing, loc=loc, use_kernel=use_kernel)
            for v, loc in zip(V, _FACE_LOCS)]


class StressCyclePreconditioner:
    """Coupled staggered V-cycle on the (full-stress) velocity block.

    The ``apply_M`` object for :func:`repro_torch.solvers.cg`: ``setup``
    binds the center viscosity operand and builds one
    :func:`~repro_torch.solvers.multigrid.make_tree_v_cycle` over the
    coarsened viscosity hierarchy, smoothing the operator CG iterates on
    and transferring each component on its own face grid.  With equal
    pre/post sweeps the cycle is symmetric, so CG stays CG.  Defaults are
    the reference's (two degree-2 Chebyshev cycles; Jacobi damping below
    2/3 for the coupled operator).
    """

    def __init__(self, grid, spacing, *, stress: str = "full", ncycles: int = 2, nu: int = 2,
                 omega: float = 0.6, coarse_sweeps: int = 30, smoother: str = "chebyshev",
                 max_levels: int | None = None, use_kernel: str = "auto"):
        if stress not in STRESSES:
            raise ValueError(f"unknown stress {stress!r}; pick from {STRESSES}")
        self.grid = grid
        self.grids = grid.hierarchy(max_levels=max_levels)
        if len(self.grids) < 2:
            raise ValueError(f"grid {grid.local_shape} cannot coarsen; multigrid needs >= 2 levels")
        self.hs = level_spacings(grid, self.grids, spacing)
        self.stress = stress
        self.ncycles = int(ncycles)
        self.use_kernel = use_kernel
        self.kw = dict(nu_pre=nu, nu_post=nu, omega=omega, coarse_sweeps=coarse_sweeps,
                       smoother=smoother)

    def setup(self, eta, *rest):
        cs = build_coefficients(self.grid, self.grids, eta.data)

        def apply_level(level, u):
            return tuple(viscous_apply(self.stress, u, cs[level], self.hs[level],
                                       self.use_kernel))

        def diag_level(level):
            fn = stn.full_stress_diag if self.stress == "full" else stn.stripped_diag
            return tuple(fn(torch, cs[level], self.hs[level]))

        v_cycle, _ = make_tree_v_cycle(self.grid, self.grids, _FACE_LOCS, apply_level,
                                       diag_level, **self.kw)

        def M(r: FieldSet) -> FieldSet:
            f = tuple(r[k].data for k in _COMPONENTS)
            e = tuple(torch.zeros_like(fi) for fi in f)
            for _ in range(self.ncycles):
                e = v_cycle(0, e, f)
            return FieldSet(**{k: r[k].with_data(ei) for k, ei in zip(_COMPONENTS, e)})

        return M


@dataclasses.dataclass
class Stokes3D:
    nx: int = 10            # local extents INCLUDING the halo cells
    ny: int = 10
    nz: int = 10
    lx: float = 1.0         # domain edge length along x (y/z scale with N)
    eta_amp: float = 0.5    # eta = 1 + amp * (smooth); keep < 1 for SPD
    theta: float = 1.3      # Uzawa step (times local eta); stable < ~1.8
    stress: str = "full"    # "full" symmetric-gradient | "stripped" block
    bc: str = "noslip"      # "noslip" | "freeslip" (tangential stress-free)
    dims: tuple | None = None          # global blocks per dim (None: one per process)
    dtype: torch.dtype = torch.float64
    use_kernel: str = "auto"           # auto | cuda | ref
    device: object = None              # None: the CUDA card
    heartbeat: int = 0                 # rank-0 heartbeat event every k solver iterations
    flight_dir: str | None = None      # per-rank flight-record dump directory

    PRECONDS = (True, "stress", "face", "center", False, None)

    def __post_init__(self):
        if self.stress not in STRESSES:
            raise ValueError(f"unknown stress {self.stress!r}; pick from {STRESSES}")
        if self.bc not in BCS:
            raise ValueError(f"unknown bc {self.bc!r}; pick from {BCS}")
        self.grid = init_global_grid(self.nx, self.ny, self.nz, dims=self.dims,
                                     dtype=self.dtype, device=self.device)
        g = self.grid
        self.dx = self.lx / (g.nx_g() - 1)
        self.spacing = (self.dx, self.dx, self.dx)
        N = g.global_shape
        amp = self.eta_amp
        self._masks: dict = {}

        # normalised coordinates in float64; face index i sits at (i + 1/2) h
        def coord(i, d, face=False):
            return (i.to(torch.float64) + (0.5 if face else 0.0)) / (N[d] - 1)

        def eta_fn(ix, iy, iz):
            x, y, z = coord(ix, 0), coord(iy, 1), coord(iz, 2)
            return 1.0 + amp * torch.sin(2 * math.pi * x) \
                * torch.sin(2 * math.pi * y) * torch.sin(2 * math.pi * z)

        def bump(x, y, z, cx, cy, cz):
            return torch.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 0.05)

        def fx_fn(ix, iy, iz):
            return bump(coord(ix, 0, True), coord(iy, 1), coord(iz, 2), 0.3, 0.5, 0.5)

        def fy_fn(ix, iy, iz):
            x, y, z = coord(ix, 0), coord(iy, 1, True), coord(iz, 2)
            return 0.3 * torch.sin(math.pi * x) * torch.cos(math.pi * y) * torch.sin(math.pi * z)

        def fz_fn(ix, iy, iz):
            return -bump(coord(ix, 0), coord(iy, 1), coord(iz, 2, True), 0.6, 0.5, 0.4)

        # evaluated at every local cell, halos included: halo-consistent
        self.eta = fields.from_global_fn(g, eta_fn, "center")
        self.F = FieldSet(vx=fields.from_global_fn(g, fx_fn, "xface"),
                          vy=fields.from_global_fn(g, fy_fn, "yface"),
                          vz=fields.from_global_fn(g, fz_fn, "zface"))

    # ------------------------------------------------------------------
    # masks (built once per location)
    # ------------------------------------------------------------------
    def _mask(self, kind: str, loc: str):
        key = (kind, loc)
        if key not in self._masks:
            fn = fields.interior_mask if kind == "interior" else fields.solve_mask
            self._masks[key] = fn(self.grid, loc, self.dtype)
        return self._masks[key]

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def _fill_ghosts(self, V: FieldSet) -> FieldSet:
        """Free-slip ghost ring: for component ``d`` and each non-staggered,
        non-periodic dim, ``neumann0`` copies the first interior plane into
        the ring, so the wall shear rate vanishes; the boundary faces along
        the component's own dim stay pinned at zero."""
        topo = self.grid.topo
        out = {}
        for name, f in V.items():
            a = f.data
            for dd in range(self.grid.ndims):
                if dd == f.stagger_dim or topo.periodic[dd]:
                    continue
                a = boundary.neumann0(topo, a, dd)
            out[name] = f.with_data(a)
        return FieldSet(**out)

    def apply_A(self, V: FieldSet, eta: Field) -> FieldSet:
        """Velocity block, zero outside each component's unknown faces.
        Refreshes the halos of ``V`` in place first (the free-slip ghost
        ring goes into a copy)."""
        V = fields.update_halo(self.grid, V)
        if self.bc == "freeslip":
            V = self._fill_ghosts(V)
        out = viscous_apply(self.stress, [V[k].data for k in _COMPONENTS], eta.data,
                            self.spacing, self.use_kernel)
        return FieldSet(**{k: V[k].with_data(o * self._mask("interior", loc))
                           for k, o, loc in zip(_COMPONENTS, out, _FACE_LOCS)})

    def _rhs(self, P: Field) -> FieldSet:
        """Momentum right-hand side ``F - grad P``."""
        G = ops.grad(P, self.spacing)
        F = self.F
        return FieldSet(vx=F.vx - G.x, vy=F.vy - G.y, vz=F.vz - G.z)

    def _grad_P(self, P: Field) -> FieldSet:
        """``grad P`` as a face FieldSet."""
        G = ops.grad(P, self.spacing)
        return FieldSet(vx=G.x, vy=G.y, vz=G.z)

    # ------------------------------------------------------------------
    # velocity solve
    # ------------------------------------------------------------------
    def _precond(self, which):
        """Velocity preconditioner: "stress" (coupled staggered tree cycle,
        the default; also ``True``), "face" (per-leaf face cycles), "center"
        (the cell-centered cycle on every leaf) or None (also ``False``)."""
        if which is True:
            which = "stress"
        if which in (False, None):
            return None
        cache = self.__dict__.setdefault("_precond_cache", {})
        if which not in cache:
            if which == "stress":
                cache[which] = StressCyclePreconditioner(self.grid, self.spacing,
                                                         stress=self.stress,
                                                         use_kernel=self.use_kernel)
            elif which in ("face", "center"):
                cache[which] = solvers.CyclePreconditioner(
                    self.grid, self.spacing, per_location=(which == "face"),
                    use_kernel=self.use_kernel)
            else:
                raise ValueError(f"unknown precond {which!r}; pick from {self.PRECONDS}")
        return cache[which]

    def velocity_solve(self, P: Field | None = None, x0: FieldSet | None = None,
                       precond="stress", tol: float = 1e-8, maxiter: int = 2000,
                       variant: str = "classic"):
        """Solve ``A V = F - grad P`` for the staggered velocity: one
        :func:`repro_torch.solvers.cg` call on the whole FieldSet.
        ``variant="pipelined"`` runs the single-reduction schedule over all
        three components.  Returns ``(V, SolveInfo)``."""
        b = self._rhs(P) if P is not None else self.F
        with self._observe(), tele.region("stokes.velocity_solve", precond=str(precond)):
            return solvers.cg(self.grid, self.apply_A, b, x0=x0, tol=tol, maxiter=maxiter,
                              apply_M=self._precond(precond), args=(self.eta,),
                              variant=variant)

    def _observe(self):
        """Runtime observability per the app's ``heartbeat``/``flight_dir``
        fields (reentrant no-op when both are off/outer-installed)."""
        return tele.observe(heartbeat=self.heartbeat, flight_dir=self.flight_dir,
                            meta={"app": "stokes", "stress": self.stress,
                                  "dims": self.grid.dims})

    # ------------------------------------------------------------------
    # pressure-space helpers
    # ------------------------------------------------------------------
    def _neg_div(self, V: FieldSet):
        """``(-div V)`` projected mean-zero over the pressure unknowns
        (halo-fresh) and its deduplicated global norm (a host float): the
        Schur matvec tail."""
        g = self.grid
        mc, ms = self._mask("interior", "center"), self._mask("solve", "center")
        d = -ops.div(V, self.spacing).data * mc
        mean = red.masked_mean(g, d, ms)
        d = (d - mean.to(d.dtype)) * mc
        n = torch.sqrt(red.dot(g, d, d, ms))
        return Field(g, g.update_halo(d), "center"), float(n)

    def _pdot(self, a: Field, b: Field) -> float:
        """Deduplicated dot over the pressure unknowns (a host float)."""
        return float(red.dot(self.grid, a.data, b.data, self._mask("solve", "center")))

    def _schur_update(self, x: Field, y: Field, scale: float) -> Field:
        """``x + scale * y`` on the pressure unknowns."""
        return Field(self.grid, (x.data + scale * y.data) * self._mask("interior", "center"),
                     "center")

    def _apply_Ms(self, r: Field) -> Field:
        """Schur preconditioner ``z = eta r``, projected mean-zero."""
        mc, ms = self._mask("interior", "center"), self._mask("solve", "center")
        z = self.eta.data * r.data * mc
        mean = red.masked_mean(self.grid, z, ms)
        return Field(self.grid, (z - mean.to(z.dtype)) * mc, "center")

    def _pressure_update(self, P: Field, V: FieldSet):
        """The viscosity-scaled Uzawa step; returns ``(P, ||div V||)``."""
        g = self.grid
        mc, ms = self._mask("interior", "center"), self._mask("solve", "center")
        divV = ops.div(V, self.spacing).data
        dn = torch.sqrt(red.psum(g.topo, torch.sum(divV ** 2 * ms)))
        P2 = (P.data - self.theta * self.eta.data * divV) * mc
        mean = red.psum(g.topo, torch.sum(P2 * ms)) / red.psum(g.topo, torch.sum(ms))
        P2 = (P2 - mean) * mc
        return P.with_data(g.update_halo(P2)), dn

    def residuals(self, V: FieldSet, P: Field) -> tuple[float, float]:
        """(relative momentum residual, absolute ||div V||) over the
        unknowns.  Refreshes the halos of ``V`` in place."""
        g = self.grid
        masks = fields.solve_mask_tree(g, self.F)
        ms = self._mask("solve", "center")
        G = ops.grad(P, self.spacing)
        AV = self.apply_A(V, self.eta)
        F = self.F
        r = FieldSet(vx=F.vx - AV.vx - G.x, vy=F.vy - AV.vy - G.y, vz=F.vz - AV.vz - G.z)
        rn = torch.sqrt(red.tree_dot(g, r, r, masks))
        fn = torch.sqrt(red.tree_dot(g, F, F, masks))
        divV = ops.div(V, self.spacing).data
        dn = torch.sqrt(red.psum(g.topo, torch.sum(divV ** 2 * ms)))
        return float(rn / fn), float(dn)

    # ------------------------------------------------------------------
    # full solve: Schur-complement CG (default) or Uzawa
    # ------------------------------------------------------------------
    def solve(self, tol: float = 1e-8, outer_maxiter: int = 400, inner_tol: float | None = None,
              precond="stress", method: str = "schur", compiled: bool = True,
              variant: str = "classic"):
        """Solve the full Stokes system.  Returns ``(V, P, StokesInfo)``.

        ``method="schur"`` runs CG on the viscosity-preconditioned Schur
        complement, each matvec one velocity solve to ``inner_tol``
        (default ``tol * 1e-2``, floored at 1e-12).  ``compiled=True`` (the
        default) follows the schedule of the reference's compiled outer
        loop, but it is not device-resident: the preconditioner is set up
        once above it, the inner solves run through
        :func:`repro_torch.solvers.cg_local`, every outer scalar is a 0-d
        device tensor, and the inner solves' convergence is checked after
        the loop; the host reads the device once per outer iteration (the
        stopping test) and once per inner CG iteration (``cg_local``'s
        residual test).  ``compiled=False`` is the host loop; both give the
        same iterates.  ``variant`` selects the inner CG schedule.
        ``method="uzawa"`` is the Richardson loop ``P <- P - theta eta div V``
        (warm-started velocity solves).  Both stop when ``||div V||`` has
        dropped by ``tol`` relative to that of the first velocity iterate.
        """
        if method not in ("schur", "uzawa"):
            raise ValueError(f"unknown method {method!r}")
        inner_tol = max(tol * 1e-2, 1e-12) if inner_tol is None else inner_tol
        with self._observe(), tele.region(f"stokes.solve.{method}", precond=str(precond),
                                          compiled=compiled and method == "schur"):
            if method == "uzawa":
                return self._solve_uzawa(tol, outer_maxiter, inner_tol, precond, variant)
            if compiled:
                return self._solve_schur_compiled(tol, outer_maxiter, inner_tol, precond,
                                                  variant)
            return self._solve_schur(tol, outer_maxiter, inner_tol, precond, variant)

    # ------------------------------------------------------------------
    # the paper's T_eff convention
    # ------------------------------------------------------------------
    def a_eff_per_iteration(self) -> int:
        """Effective bytes per velocity-CG iteration: the three face velocity
        components read and written, the viscosity and the three rhs
        components read once: ``(2 * 3 + 4) * n_cells * itemsize``."""
        n = int(np.prod(self.grid.global_shape))
        return a_eff(n, n_unknown_fields=3, n_known_fields=4, itemsize=self.dtype.itemsize)

    def t_eff(self, info) -> float:
        """T_eff in GB/s for a recorded velocity solve."""
        return t_eff(self.a_eff_per_iteration(), info.s_per_iter())

    def _zero_velocity(self) -> FieldSet:
        return FieldSet(**{k: fields.zeros(self.grid, loc, self.dtype)
                           for k, loc in zip(_COMPONENTS, _FACE_LOCS)})

    def _solve_uzawa(self, tol, outer_maxiter, inner_tol, precond, variant="classic"):
        V = self._zero_velocity()
        P = fields.zeros(self.grid, "center", self.dtype)
        inner_total = first_inner = 0
        d0 = dn = None
        k = 0
        for k in range(1, outer_maxiter + 1):
            V, info = self.velocity_solve(P=P, x0=V, precond=precond, tol=inner_tol,
                                          variant=variant)
            inner_total += info.iterations
            if k == 1:
                first_inner = info.iterations
            P, dn = self._pressure_update(P, V)
            dn = float(dn)
            if d0 is None:
                d0 = dn if dn > 0 else 1.0
            if dn <= tol * d0:
                break
        rm, _ = self.residuals(V, P)
        relres_div = dn / d0
        return V, P, StokesInfo(outer_iterations=k, inner_iterations=inner_total,
                                first_inner_iterations=first_inner, relres_momentum=rm,
                                relres_div=relres_div, converged=relres_div <= tol)

    @staticmethod
    def _check_inner(info, what):
        """A Schur matvec is only as exact as its inner solve: an unconverged
        one would poison the outer recurrence, so it raises."""
        if not info.converged:
            raise RuntimeError(
                f"Schur-CG inner velocity solve ({what}) did not converge: relres "
                f"{info.relres:.2e} after {info.iterations} iterations; raise inner_tol/"
                "maxiter or strengthen the velocity preconditioner")

    def _solve_schur(self, tol, outer_maxiter, inner_tol, precond, variant="classic"):
        # b_S = -div A^-1 F: one velocity solve for the rhs (and the warm
        # start of the final velocity recovery)
        V0, info0 = self.velocity_solve(precond=precond, tol=inner_tol, variant=variant)
        self._check_inner(info0, "rhs A V0 = F")
        inner_total = first_inner = info0.iterations
        b_S, d0 = self._neg_div(V0)
        d0 = d0 if d0 > 0 else 1.0
        P = fields.zeros(self.grid, "center", self.dtype)
        r = b_S
        z = self._apply_Ms(r)
        p = z
        rz = self._pdot(r, z)
        res = self._pdot(r, r) ** 0.5
        k = 0
        while res > tol * d0 and k < outer_maxiter:
            k += 1
            # Schur matvec: one velocity solve (A W = grad p) per CG step
            W, wi = solvers.cg(self.grid, self.apply_A, self._grad_P(p), tol=inner_tol,
                               maxiter=2000, apply_M=self._precond(precond), args=(self.eta,),
                               variant=variant)
            self._check_inner(wi, f"matvec A W = grad p, outer step {k}")
            inner_total += wi.iterations
            Sp, _ = self._neg_div(W)
            alpha = rz / self._pdot(p, Sp)
            P = self._schur_update(P, p, alpha)
            r = self._schur_update(r, Sp, -alpha)
            z = self._apply_Ms(r)
            rz_new = self._pdot(r, z)
            p = self._schur_update(z, p, rz_new / rz)
            rz = rz_new
            res = self._pdot(r, r) ** 0.5
        # recover the velocity for the final pressure (warm start: V0)
        V, infoF = self.velocity_solve(P=P, x0=V0, precond=precond, tol=inner_tol,
                                       variant=variant)
        self._check_inner(infoF, "final A V = F - grad P")
        inner_total += infoF.iterations
        rm, _ = self.residuals(V, P)
        relres_div = res / d0
        return V, P, StokesInfo(outer_iterations=k, inner_iterations=inner_total,
                                first_inner_iterations=first_inner, relres_momentum=rm,
                                relres_div=relres_div, converged=relres_div <= tol)

    def _solve_schur_compiled(self, tol, outer_maxiter, inner_tol, precond, variant="classic",
                              inner_maxiter=2000):
        """The Schur-CG recurrence of :meth:`_solve_schur` on the schedule
        of the reference's compiled loop: the preconditioner is set up
        once, each matvec is one :func:`repro_torch.solvers.cg_local`
        velocity solve, and every outer scalar stays a 0-d tensor.  The
        host reads the device once per outer iteration, for the stopping
        test (which also stops at the first inner solve that did not
        converge, as the reference's loop predicate does), and once per
        inner CG iteration inside ``cg_local``.  The inner solves'
        convergence flag and worst relative residual are checked after the
        loop.  Under an analyzer capture the loop is recorded, not run."""
        if _cap.capturing():   # an analyzer capture: record this solve, run nothing
            _cap.maybe_capture("stokes.schur", self.grid, (self.F, self.eta),
                               lambda: self._solve_schur_compiled(
                                   tol, outer_maxiter, inner_tol, precond, variant,
                                   inner_maxiter))
        g = self.grid
        eta = self.eta
        pre = self._precond(precond)
        M = pre.setup(eta) if pre is not None else None
        mc, ms = self._mask("interior", "center"), self._mask("solve", "center")

        def A(V):
            return self.apply_A(V, eta)

        def negdiv(V):
            d = -ops.div(V, self.spacing).data * mc
            mean = red.masked_mean(g, d, ms)
            d = (d - mean.to(d.dtype)) * mc
            return d, torch.sqrt(red.dot(g, d, d, ms))

        def apply_Ms(rd):
            z = eta.data * rd * mc
            mean = red.masked_mean(g, z, ms)
            return (z - mean.to(z.dtype)) * mc

        def gradp(Ph):
            # Ph is a halo-updated center tensor
            return self._grad_P(Field(g, Ph, "center"))

        def vsolve(b, x0):
            x, kk, relres, _ = solvers.cg_local(g, A, b, x0, tol=inner_tol, maxiter=inner_maxiter,
                                                apply_M=M, variant=variant)
            return x, kk, relres

        F = self.F
        zeros_v = self._zero_velocity()
        V0, k0, rr0 = vsolve(F, zeros_v)
        b_S, d0 = negdiv(V0)
        d0 = torch.where(d0 > 0, d0, torch.ones_like(d0))
        r = b_S
        z = apply_Ms(r)
        p = z
        rz, rr = red.tree_dot_many(g, ((r, z), (r, r)), ms)
        res = torch.sqrt(rr)
        Pd = torch.zeros_like(b_S)
        k, itot = 0, k0
        ok, worst = rr0 <= inner_tol, rr0
        thresh = tol * d0
        while k < outer_maxiter and _mk.loop_bool((res > thresh) & ok, site="apps.stokes.schur",
                                                  first=k == 0):
            # Schur matvec: one whole velocity solve per outer step
            W, kw, rrw = vsolve(gradp(g.update_halo(p.clone())), zeros_v)
            Sp, _ = negdiv(W)
            alpha = rz / red.dot(g, p, Sp, ms)
            Pd = (Pd + alpha.to(Pd.dtype) * p) * mc
            r = (r - alpha.to(r.dtype) * Sp) * mc
            z = apply_Ms(r)
            # <r, z> and ||r||^2 as one reduction, like classic CG
            rz_new, rr = red.tree_dot_many(g, ((r, z), (r, r)), ms)
            beta = rz_new / rz
            p = (z + beta.to(p.dtype) * p) * mc
            rz, res = rz_new, torch.sqrt(rr)
            k, itot = k + 1, itot + kw
            ok, worst = ok & (rrw <= inner_tol), torch.maximum(worst, rrw)
        # recover the velocity for the final pressure (warm start: V0)
        Ph = g.update_halo(Pd)
        G = gradp(Ph)
        V, kf, rrf = vsolve(FieldSet(vx=F.vx - G.vx, vy=F.vy - G.vy, vz=F.vz - G.vz), V0)
        ok, worst = ok & (rrf <= inner_tol), torch.maximum(worst, rrf)
        if _mk.TRACE is not None:   # a capture stops before the host reads
            return V, None, None
        if not bool(ok):
            raise RuntimeError(
                "Schur-CG inner velocity solve did not converge inside the outer loop "
                f" (worst inner relres {float(worst):.2e} vs inner_tol "
                f"{inner_tol:.2e}); raise inner_tol/maxiter or strengthen the velocity "
                "preconditioner")
        P = Field(g, Ph, "center")
        rm, _ = self.residuals(V, P)
        relres_div = float(res / d0)
        return V, P, StokesInfo(outer_iterations=k, inner_iterations=itot + kf,
                                first_inner_iterations=k0, relres_momentum=rm,
                                relres_div=relres_div, converged=relres_div <= tol)

    # ------------------------------------------------------------------
    # NumPy oracle: single-array implementation on the gathered grid
    # ------------------------------------------------------------------
    def _oracle_parts(self):
        """Gathered global arrays + the oracle's operator application."""
        N = self.grid.global_shape
        eta = fields.gather(self.eta).astype(np.float64)

        def pad_valid(f):
            sd = f.stagger_dim
            return np.pad(fields.gather(f).astype(np.float64),
                          [(0, 1) if d == sd else (0, 0) for d in range(3)])

        F = [pad_valid(self.F.vx), pad_valid(self.F.vy), pad_valid(self.F.vz)]

        # unknowns: component d spans [1, N-2) along d (faces), [1, N-1)
        # across; pressure spans [1, N-1) everywhere
        def region(d=None):
            sl = [slice(1, n - 1) for n in N]
            if d is not None:
                sl[d] = slice(1, N[d] - 2)
            return tuple(sl)

        freeslip = self.bc == "freeslip"

        def fill_ghosts(V):
            """The gathered-array mirror of :meth:`_fill_ghosts` (free-slip
            zero-flux tangential planes; nothing under no-slip)."""
            if not freeslip:
                return V
            out = []
            for d, u in enumerate(V):
                u = u.copy()
                for dd in range(3):
                    if dd == d:
                        continue
                    lo = [slice(None)] * 3
                    hi = [slice(None)] * 3
                    lo[dd], hi[dd] = 0, 1
                    u[tuple(lo)] = u[tuple(hi)]
                    lo[dd], hi[dd] = N[dd] - 1, N[dd] - 2
                    u[tuple(lo)] = u[tuple(hi)]
                out.append(u)
            return out

        apply_raw = stn.full_stress_apply if self.stress == "full" else stn.stripped_apply
        h = self.spacing

        def A_np(V):
            """The velocity block on the global arrays (region output)."""
            raw = apply_raw(np, fill_ghosts(V), eta, h)
            out = []
            for d in range(3):
                o = np.zeros(N)
                o[region(d)] = raw[d][region(d)]
                out.append(o)
            return out

        def grad_np(Pr, d):
            reg = region(d)
            sl = list(reg)
            r_ = sl[d]
            sl[d] = slice(r_.start + 1, r_.stop + 1)
            out = np.zeros(N)
            out[reg] = (Pr[tuple(sl)] - Pr[reg]) / h[d]
            return out

        def div_np(V):
            reg = region()
            out = np.zeros(N)
            for d in range(3):
                sl = list(reg)
                r_ = sl[d]
                sl[d] = slice(r_.start - 1, r_.stop - 1)
                out[reg] += (V[d][reg] - V[d][tuple(sl)]) / h[d]
            return out

        return N, eta, F, region, A_np, grad_np, div_np

    def oracle_apply(self, V):
        """Oracle operator application on a 3-list of full global-shape
        arrays (dead planes and pinned faces zero)."""
        _, _, _, _, A_np, _, _ = self._oracle_parts()
        return A_np([np.asarray(v, np.float64) for v in V])

    def oracle(self, tol: float = 1e-10, inner_tol: float = 1e-12, outer_maxiter: int = 5000):
        """Solve the same discrete system in NumPy on the global grid:
        coupled-CG velocity solves inside a viscosity-scaled Uzawa outer
        loop (deliberately not the device's Schur-CG).  Returns ``(Vx, Vy,
        Vz, P)`` as full global-shape arrays (dead planes zero, P mean-zero
        over its unknowns)."""
        N, eta, F, region, A_np, grad_np, div_np = self._oracle_parts()
        regs = [region(d) for d in range(3)]
        regc = region()

        def dot3(a, b):
            return sum(float((a[d][regs[d]] * b[d][regs[d]]).sum()) for d in range(3))

        def cg3(b, x, tol, maxiter=20000):
            r = [np.zeros(N) for _ in range(3)]
            Ax = A_np(x)
            for d in range(3):
                r[d][regs[d]] = (b[d] - Ax[d])[regs[d]]
            p = [ri.copy() for ri in r]
            rs = dot3(r, r)
            bn = dot3(b, b) ** 0.5 or 1.0
            for _ in range(maxiter):
                if rs ** 0.5 <= tol * bn:
                    break
                Ap = A_np(p)
                alpha = rs / dot3(p, Ap)
                for d in range(3):
                    x[d] = x[d] + alpha * p[d]
                    r[d][regs[d]] -= alpha * Ap[d][regs[d]]
                rs_new = dot3(r, r)
                beta = rs_new / rs
                p = [r[d] + beta * p[d] for d in range(3)]
                rs = rs_new
            return x

        V = [np.zeros(N) for _ in range(3)]
        P = np.zeros(N)
        d0 = None
        for _ in range(outer_maxiter):
            rhs = [F[d] - grad_np(P, d) for d in range(3)]
            V = cg3(rhs, V, inner_tol)
            divV = div_np(V)
            dn = float((divV[regc] ** 2).sum()) ** 0.5
            if d0 is None:
                d0 = dn if dn > 0 else 1.0
            P2 = np.zeros(N)
            P2[regc] = P[regc] - self.theta * eta[regc] * divV[regc]
            P2[regc] -= P2[regc].mean()
            P = P2
            if dn <= tol * d0:
                break
        return V[0], V[1], V[2], P
