"""3-D variable-coefficient Poisson, solved three ways.

    -div( c(x) grad u ) = f

on the implicit global grid, with the solvers of
:mod:`repro_torch.solvers` — CG (classic and pipelined, plain or
MG-preconditioned), accelerated pseudo-transient and geometric multigrid —
all judged on the same deduplicated global relative residual, and checked
against a single-array NumPy oracle (matrix-free CG on the gathered grid).

Boundary conditions per dim follow ``periodic``: ``u = 0`` on the ring of
non-periodic dims, wraparound on periodic dims.  With EVERY dim periodic
the operator is singular: ``cg``/``mgcg`` run with
``project_nullspace="constant"`` and ``mg`` projects internally, all
returning the mean-zero representative; ``pt`` is rejected.

On a CUDA tensor every operator application is kernel K2 and the V-cycle's
residuals and sweeps are K3-K5.  Under a ``torch.distributed`` group every
process solves over the blocks it holds, and :meth:`Poisson3D.oracle`
runs on the gathered arrays on every process.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import solvers
from ..core import init_global_grid
from ..solvers.multigrid import poisson_apply
from .. import telemetry as tele
from ..telemetry import a_eff, t_eff


@dataclasses.dataclass
class Poisson3D:
    nx: int = 10            # local extents INCLUDING the halo cells
    ny: int = 10
    nz: int = 10
    lx: float = 1.0         # domain edge length along x (y/z scale with N)
    coef_amp: float = 0.5   # c = 1 + amp * (smooth); keep < 1 for SPD
    periodic: tuple = (False, False, False)
    dims: tuple | None = None          # global blocks per dim (None: one per process)
    dtype: torch.dtype = torch.float64
    use_kernel: str = "auto"           # auto | cuda | ref
    device: object = None              # None: the CUDA card
    heartbeat: int = 0                 # rank-0 heartbeat event every k solver iterations
    flight_dir: str | None = None      # per-rank flight-record dump directory

    def __post_init__(self):
        self.grid = init_global_grid(self.nx, self.ny, self.nz, dims=self.dims,
                                     periodic=self.periodic, dtype=self.dtype,
                                     device=self.device)
        g = self.grid
        self.singular = all(g.topo.periodic)   # shift-free + all-periodic

        # Uniform spacing set by the x extent; grid.span is periodic-aware.
        self.dx = self.lx / g.span(0)
        self.spacing = (self.dx, self.dx, self.dx)
        N = g.global_shape
        amp = self.coef_amp
        per = g.topo.periodic
        h = g.halo

        # Normalized coordinate per dim: periodic dims use x = (i-h)/P, so a
        # period-1 function of x is wrap-consistent on the ring duplicates;
        # Dirichlet dims use i/(N-1).  Computed in float64.
        def coords(ix, iy, iz):
            out = []
            for d, i in enumerate((ix, iy, iz)):
                i = i.to(torch.float64)
                out.append((i - h) / g.span(d) if per[d] else i / (N[d] - 1))
            return out

        def c_fn(ix, iy, iz):
            x, y, z = coords(ix, iy, iz)
            return 1.0 + amp * torch.sin(2 * math.pi * x) \
                * torch.sin(2 * math.pi * y) * torch.sin(2 * math.pi * z)

        def f_fn(ix, iy, iz):
            x, y, z = coords(ix, iy, iz)
            if not any(per):
                bump = torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.02)
                return bump * torch.sin(math.pi * x)
            # periodic dims need a wrap-consistent (period-1) rhs; the product
            # of sines is also mean-zero, keeping the singular system consistent
            parts = [torch.sin(2 * math.pi * v) if per[d] else torch.sin(math.pi * v)
                     for d, v in enumerate((x, y, z))]
            return parts[0] * parts[1] * parts[2]

        self.c = g.from_global_fn(c_fn)
        self.b = g.from_global_fn(f_fn)

    # ------------------------------------------------------------------
    # operator (local view)
    # ------------------------------------------------------------------
    def apply_A(self, u, c):
        """``A u`` (kernel K2 on a CUDA tensor); refreshes ``u``'s halo in
        place first."""
        return poisson_apply(self.grid, u, c, self.spacing, use_kernel=self.use_kernel)

    def apply_A_overlap(self, u, c):
        """The same operator through ``hide_apply``: the same values, ``u``
        untouched (its halo update goes into a copy)."""
        return poisson_apply(self.grid, u, c, self.spacing, hide=True,
                             use_kernel=self.use_kernel)

    def spectral_bounds(self) -> tuple[float, float]:
        """(lam_min, lam_max) estimates for the pseudo-transient solver:
        Gershgorin upper bound; lowest-Fourier-mode lower bound over the
        Dirichlet dims (all-periodic gives 0: singular)."""
        g = self.grid
        c_min = float(solvers.field_min_g(g, self.c))
        c_max = float(solvers.field_max_g(g, self.c))
        lam_max = c_max * sum(4.0 / h ** 2 for h in self.spacing)
        lam_min = c_min * sum(
            (np.pi / ((n - 1) * h)) ** 2
            for d, (n, h) in enumerate(zip(g.global_shape, self.spacing))
            if not g.topo.periodic[d])
        return lam_min, lam_max

    # ------------------------------------------------------------------
    # the paper's effective-memory-throughput convention
    # ------------------------------------------------------------------
    def a_eff_per_iteration(self) -> int:
        """Effective bytes per solver iteration: ``u`` read and written once,
        ``c`` and ``b`` read once — ``(2 * 1 + 2) * n_cells * itemsize``."""
        n = int(np.prod(self.grid.global_shape))
        return a_eff(n, n_unknown_fields=1, n_known_fields=2, itemsize=self.dtype.itemsize)

    def t_eff(self, info) -> float:
        """T_eff in GB/s for a recorded solve (NaN before timing)."""
        return t_eff(self.a_eff_per_iteration(), info.s_per_iter())

    # ------------------------------------------------------------------
    # solves
    # ------------------------------------------------------------------
    def solve(self, method: str = "cg", tol: float = 1e-6, maxiter: int | None = None,
              overlap: bool = False, **kw):
        """Solve with ``method`` in {"cg", "pipecg", "mgcg", "pipemgcg",
        "pt", "mg"}; ``**kw`` go to the solver.  ``pipecg``/``pipemgcg`` are
        the pipelined schedules of cg/mgcg.  ``overlap=True`` (cg family and
        pt) switches the operator to ``hide_apply``.
        Returns ``(u, info)``.
        """
        with self._observe(), tele.region(f"poisson.solve.{method}", singular=self.singular,
                                          overlap=overlap):
            return self._solve(method, tol, maxiter, overlap, **kw)

    def _observe(self):
        """Runtime observability per the app's ``heartbeat``/``flight_dir``
        fields (reentrant no-op when both are off/outer-installed)."""
        return tele.observe(heartbeat=self.heartbeat, flight_dir=self.flight_dir,
                            meta={"app": "poisson", "dims": self.grid.dims})

    def _solve(self, method, tol, maxiter, overlap, **kw):
        apply_A = self.apply_A_overlap if overlap else self.apply_A
        project = "constant" if self.singular else None
        if method in ("pipecg", "pipemgcg"):
            kw.setdefault("variant", "pipelined")
            method = "cg" if method == "pipecg" else "mgcg"
        if method == "cg":
            return solvers.cg(self.grid, apply_A, self.b, tol=tol,
                              maxiter=maxiter or 2000, args=(self.c,),
                              project_nullspace=project, **kw)
        if method == "mgcg":
            if not hasattr(self, "_mg_precond"):
                self._mg_precond = solvers.CyclePreconditioner(
                    self.grid, self.spacing, use_kernel=self.use_kernel)
            return solvers.cg(self.grid, apply_A, self.b, tol=tol,
                              maxiter=maxiter or 2000, args=(self.c,),
                              apply_M=self._mg_precond, project_nullspace=project, **kw)
        if method == "pt":
            if self.singular:
                raise ValueError(
                    "method='pt' needs lam_min > 0, but the all-periodic Poisson operator "
                    "is singular — use 'cg'/'mgcg' (nullspace-projected) or 'mg'")
            lam_min, lam_max = self.spectral_bounds()
            return solvers.pseudo_transient(self.grid, apply_A, self.b, tol=tol,
                                            maxiter=maxiter or 20000, args=(self.c,),
                                            lam_min=lam_min, lam_max=lam_max, **kw)
        if method == "mg":
            if overlap:
                raise ValueError("overlap=True is not supported for 'mg' (the V-cycle "
                                 "manages its own halo updates)")
            kw.setdefault("use_kernel", self.use_kernel)
            return solvers.multigrid_solve(self.grid, self.c, self.b, self.spacing, tol=tol,
                                           maxiter=maxiter or 100, **kw)
        raise ValueError(f"unknown method {method!r}")

    def residual_norm(self, u) -> float:
        """Relative residual over the unknowns, with the solvers' mask and
        zero-rhs guard (against the mean-zero rhs when singular), in the
        app's dtype.  ``u`` is not modified."""
        g = self.grid
        mask = solvers.solve_mask(g, self.b.dtype)
        b = self.b
        if self.singular:
            b = b - solvers.masked_mean(g, b, mask).to(b.dtype)
        r = b - self.apply_A(u.to(b.dtype, copy=True), self.c)
        return float(solvers.norm_l2(g, r, mask) / solvers.rhs_norm(g, b, mask))

    # ------------------------------------------------------------------
    # NumPy oracle (single global array, matrix-free CG)
    # ------------------------------------------------------------------
    def oracle(self, tol: float = 1e-10, maxiter: int = 20000) -> np.ndarray:
        """Matrix-free NumPy CG on the gathered global arrays.

        The ring planes of periodic dims are ghost cells refreshed by a
        wrap copy before each operator application, and the singular
        all-periodic system is projected onto mean-zero (rhs and solution).
        """
        g = self.grid
        per = g.topo.periodic
        c = g.gather(self.c).astype(np.float64)
        b = g.gather(self.b).astype(np.float64)
        h2 = np.asarray(self.spacing, np.float64) ** 2
        inner = (slice(1, -1),) * 3

        def wrap(u):
            # periodic ghost update (h = 1): ring == opposite interior
            for d in range(3):
                if not per[d]:
                    continue
                lo = [slice(None)] * 3
                hi = [slice(None)] * 3
                lo[d], hi[d] = 0, -2
                u[tuple(lo)] = u[tuple(hi)]
                lo[d], hi[d] = -1, 1
                u[tuple(lo)] = u[tuple(hi)]
            return u

        wrap(c)

        def demean(u):
            if self.singular:
                u[inner] -= u[inner].mean()
            return u

        def apply_A(u):
            u = wrap(u.copy())
            out = np.zeros_like(u)
            u0 = u[1:-1, 1:-1, 1:-1]
            c0 = c[1:-1, 1:-1, 1:-1]
            acc = np.zeros_like(u0)
            for d in range(3):
                sl_p = [slice(1, -1)] * 3
                sl_m = [slice(1, -1)] * 3
                sl_p[d] = slice(2, None)
                sl_m[d] = slice(None, -2)
                cf_p = 0.5 * (c0 + c[tuple(sl_p)])
                cf_m = 0.5 * (c0 + c[tuple(sl_m)])
                acc += (cf_p * (u[tuple(sl_p)] - u0)
                        - cf_m * (u0 - u[tuple(sl_m)])) / h2[d]
            out[1:-1, 1:-1, 1:-1] = -acc
            return out

        b = demean(b.copy())
        x = np.zeros_like(b)
        r = np.zeros_like(b)
        r[inner] = b[inner]
        p = r.copy()
        rs = float((r[inner] ** 2).sum())
        bnorm = rs ** 0.5 or 1.0
        for _ in range(maxiter):
            if rs ** 0.5 <= tol * bnorm:
                break
            Ap = apply_A(p)
            alpha = rs / float((p[inner] * Ap[inner]).sum())
            x += alpha * p
            r[inner] -= alpha * Ap[inner]
            rs_new = float((r[inner] ** 2).sum())
            p = r + (rs_new / rs) * p
            rs = rs_new
        return wrap(demean(x))
