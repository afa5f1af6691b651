"""Paper Fig. 3: nonlinear 3-D poro-viscous two-phase flow (porosity waves).

Effective pressure ``Pe`` and porosity ``phi`` coupled through a
porosity-dependent Darcy flux and viscous (de)compaction on a regular
staggered grid: fluxes on cell faces, scalars at centers, all
:mod:`repro_torch.fields` Fields.

    qx,qy,qz = -k(phi) * (d(Pe)/dxi - delta_z)     (faces; unit buoyancy)
    dPe/dt   = -div q - Pe / eta_phi(phi)          (centers)
    dphi/dt  = (1 - phi) * Pe / eta_phi(phi)

with ``k(phi) = (phi/phi0)^npow`` and ``eta_phi = eta0/phi0 * (phi0/phi)^m``.

Two time integrators (``method=``):

* ``"explicit"``: one stencil sweep per step, through
  :func:`repro_torch.fields.hide_step` (boundary shell first, the halo
  exchange on a side stream beside the interior) or ``update_halo`` with
  ``hide=None``; the parabolic pressure operator restricts ``dt < dx^2 /
  (6 k_max)``.
* ``"cg"`` / ``"mgcg"``: backward-Euler pressure, each step an SPD
  Helmholtz-like solve (:mod:`repro_torch.apps.twophase_ops`) by
  :func:`repro_torch.solvers.cg`, plain or preconditioned by the shifted
  multigrid :class:`repro_torch.solvers.CyclePreconditioner`; ``overlap=True``
  applies the operator through ``hide_apply`` (on a halo-updated copy of
  the input, which stays as it was).  On a CUDA tensor every operator application is kernel
  K2 and every residual and smoothing sweep of the cycle K3/K4, all with
  the shift ``1/dt + 1/eta``.

The porosity is advanced with the new pressure; the nonlinear coefficients
are frozen at the old porosity.  Any mix of periodic and Dirichlet dims
works with every integrator, and under a ``torch.distributed`` group every
process steps the blocks it holds (:meth:`TwoPhase3D.oracle` runs on the
gathered arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import fields as flds
from .. import solvers
from .._device import synchronize
from ..core import init_global_grid
from ..fields import Field, FieldSet
from ..stencil import fd3d as fd
from .. import telemetry as tele
from ..telemetry import a_eff, t_eff
from .twophase_ops import darcy_flux, pressure_apply, pressure_rhs

METHODS = ("explicit", "cg", "mgcg")
_INNER = (Ellipsis, slice(1, -1), slice(1, -1), slice(1, -1))


@dataclasses.dataclass
class TwoPhase3D:
    nx: int = 32            # local extents INCLUDING the halo cells
    ny: int = 32
    nz: int = 32
    phi0: float = 0.01
    npow: float = 3.0
    m: float = 1.0
    eta0: float = 1.0
    lx: float = 10.0
    dt: float | None = None  # None: dt_limit (explicit) / 10x dt_limit (implicit)
    method: str = "explicit"
    tol: float = 1e-8        # implicit per-step relative solve tolerance
    maxiter: int = 500       # implicit per-step CG iteration cap
    overlap: bool = False    # hide_apply overlap on the implicit operator
    variant: str = "classic"  # Krylov schedule: "classic" | "pipelined"
    hide: tuple | None = (8, 2, 2)   # explicit-step communication hiding
    periodic: tuple = (False, False, False)
    dims: tuple | None = None          # global blocks per dim (None: one per process)
    dtype: torch.dtype = torch.float64
    use_kernel: str = "auto"           # auto | cuda | ref (pressure operator, cycle)
    device: object = None              # None: the CUDA card
    heartbeat: int = 0                 # rank-0 heartbeat event every k solver iterations
    flight_dir: str | None = None      # per-rank flight-record dump directory

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; pick from {METHODS}")
        if len(self.periodic) != 3:
            raise ValueError(f"periodic must be a 3-tuple of bools, got {self.periodic!r}")
        self.grid = init_global_grid(self.nx, self.ny, self.nz, dims=self.dims,
                                     periodic=self.periodic, dtype=self.dtype,
                                     device=self.device)
        g = self.grid
        if self.method == "mgcg" and not g.can_coarsen():
            raise ValueError(
                f"method='mgcg' needs a coarsenable grid, but local shape {g.local_shape} "
                "admits no second multigrid level: enlarge the local extents (even "
                "interiors >= 4) or use method='cg'")

        # grid.span is periodic-aware: N-1 node intervals bracket a Dirichlet
        # dim, a periodic dim has N - overlap cells per period.
        self.dx = self.lx / g.span(0)
        self.dy = self.lx / g.span(1)
        self.dz = self.lx / g.span(2)
        self.spacing = (self.dx, self.dy, self.dz)
        # explicit stability: dt < dx^2 / (6 k_max) with k_max = (phi_max /
        # phi0)^npow = 4^npow for the 3x-amplitude seed
        k_max = 4.0 ** self.npow
        self.dt_limit = 0.2 * min(self.spacing) ** 2 / (6.0 * k_max)
        if self.dt is None:
            self.dt = self.dt_limit if self.method == "explicit" else 10.0 * self.dt_limit
        elif self.method == "explicit":
            self.dt = min(self.dt, self.dt_limit)
        dx, dy, dz, dt = self.dx, self.dy, self.dz, self.dt
        phi0, npow = self.phi0, self.npow

        def step(Pe, phi):
            k = (phi / phi0) ** npow                      # permeability
            ie = self._inv_eta(phi)                       # 1 / eta_phi
            kx, ky, kz = fd.av_xi(k), fd.av_yi(k), fd.av_zi(k)
            qx = -kx * fd.d_xi(Pe) / dx                   # (nx-1, ny-2, nz-2)
            qy = -ky * fd.d_yi(Pe) / dy
            # vertical flux with unit buoyancy (Delta-rho * g = 1): the term
            # that drives the porosity wave
            qz = -kz * (fd.d_zi(Pe) / dz - 1.0)
            divq = fd.d_xa(qx) / dx + fd.d_ya(qy) / dy + fd.d_za(qz) / dz
            pe_i, phi_i, ie_i = fd.inn(Pe), fd.inn(phi), fd.inn(ie)
            dPe = -divq - pe_i * ie_i
            dphi = (1.0 - phi_i) * pe_i * ie_i
            Pe2 = Pe.clone(memory_format=torch.contiguous_format)
            Pe2[_INNER] = pe_i + dt * dPe
            phi2 = phi.clone(memory_format=torch.contiguous_format)
            phi2[_INNER] = torch.clamp(phi_i + dt * dphi, 1e-4, 0.25)
            return Pe2, phi2

        self._single_step = step

        def fstep(S):
            Pe2, phi2 = step(S.Pe.data, S.phi.data)
            return FieldSet(Pe=S.Pe.with_data(Pe2), phi=S.phi.with_data(phi2))

        if self.hide is not None:
            local = g.local_shape
            width = tuple(max(1, min(w, local[d] // 2 - 1)) for d, w in enumerate(self.hide))

            def dstep(S):
                return flds.hide_step(g, fstep, S, width=width)
        else:
            width = None

            def dstep(S):
                return flds.update_halo(g, fstep(S))

        self._explicit_step = dstep
        self._hide_widths = width

    def _inv_eta(self, phi):
        return (self.phi0 / self.eta0) * (phi / self.phi0) ** self.m

    # ------------------------------------------------------------------
    # implicit pressure: assembly, operator (local view), solve
    # ------------------------------------------------------------------
    def _assemble(self, Pe: Field, phi: Field):
        """``(k, diag, rhs)`` of one backward-Euler step from the old state."""
        k = (phi.data / self.phi0) ** self.npow
        diag = 1.0 / self.dt + self._inv_eta(phi.data)
        return k, diag, Pe.with_data(pressure_rhs(Pe.data, k, self.dt, self.dz))

    def _phi_update(self, phi: Field, Pe: Field) -> Field:
        """Porosity advanced with the new pressure, halo-updated."""
        ie = self._inv_eta(phi.data)
        p0 = phi.data[_INNER]
        new = phi.data.clone()
        new[_INNER] = torch.clamp(p0 + self.dt * (1.0 - p0) * Pe.data[_INNER] * ie[_INNER],
                                  1e-4, 0.25)
        return phi.with_data(self.grid.update_halo(new))

    def apply_A(self, u: Field, k, diag) -> Field:
        """Backward-Euler pressure operator on a center Field (refreshes
        ``u``'s halo in place first)."""
        return u.with_data(pressure_apply(self.grid, u.data, k, diag, self.spacing,
                                          use_kernel=self.use_kernel))

    def apply_A_overlap(self, u: Field, k, diag) -> Field:
        """The same operator through ``hide_apply``: the same values, ``u``
        untouched (its halo update goes into a copy)."""
        return u.with_data(pressure_apply(self.grid, u.data, k, diag, self.spacing, hide=True,
                                          use_kernel=self.use_kernel))

    def _precond(self):
        if not hasattr(self, "_mg_precond"):
            # the cycle must see the 1/dt + 1/eta diagonal (args[1]): a pure
            # Poisson cycle mis-preconditions the shifted operator
            self._mg_precond = solvers.CyclePreconditioner(
                self.grid, self.spacing, helmholtz_shift=True, use_kernel=self.use_kernel)
        return self._mg_precond

    def pressure_solve(self, S: FieldSet, tol: float | None = None,
                       maxiter: int | None = None):
        """One implicit pressure solve ``A Pe^{n+1} = Pe^n/dt - G``, warm-started
        from the old pressure.  Returns ``(Pe, SolveInfo)``."""
        k, diag, rhs = self._assemble(S.Pe, S.phi)
        apply_A = self.apply_A_overlap if self.overlap else self.apply_A
        return solvers.cg(self.grid, apply_A, rhs, x0=S.Pe,
                          tol=self.tol if tol is None else tol,
                          maxiter=self.maxiter if maxiter is None else maxiter,
                          apply_M=self._precond() if self.method == "mgcg" else None,
                          args=(k, diag), variant=self.variant)

    # ------------------------------------------------------------------
    # time stepping
    # ------------------------------------------------------------------
    def init_fields(self) -> FieldSet:
        """Gaussian porosity perturbation (the porosity-wave seed)."""
        g = self.grid
        cx, cy, cz = g.nx_g() / 2, g.ny_g() / 2, g.nz_g() / 4

        def phi_fn(ix, iy, iz):
            r2 = (((ix.double() - cx) * self.dx) ** 2 + ((iy.double() - cy) * self.dy) ** 2
                  + ((iz.double() - cz) * self.dz) ** 2)
            return self.phi0 * (1.0 + 3.0 * torch.exp(-r2 / 0.5))

        return FieldSet(Pe=flds.zeros(g, "center", self.dtype),
                        phi=flds.from_global_fn(g, phi_fn, "center"))

    def step(self, S: FieldSet):
        """Advance one ``dt``.  Returns ``(state, SolveInfo | None)``."""
        if self.method == "explicit":
            return self._explicit_step(S), None
        Pe, info = self.pressure_solve(S)
        return FieldSet(Pe=Pe, phi=self._phi_update(S.phi, Pe)), info

    def run(self, nt: int, S: FieldSet | None = None):
        """Advance ``nt`` steps.  Returns ``(state, [SolveInfo, ...])`` (empty
        for the explicit integrator)."""
        if S is None:
            S = self.init_fields()
        infos = []
        with self._observe(), tele.region("twophase.run", nt=nt, method=self.method):
            for _ in range(nt):
                S, info = self.step(S)
                if info is not None:
                    infos.append(info)
            synchronize(S.Pe.data)
        return S, infos

    def _observe(self):
        """Runtime observability per the app's ``heartbeat``/``flight_dir``
        fields (reentrant no-op when both are off/outer-installed)."""
        return tele.observe(heartbeat=self.heartbeat, flight_dir=self.flight_dir,
                            meta={"app": "twophase", "method": self.method,
                                  "dims": self.grid.dims})

    def fluxes(self, S: FieldSet) -> FieldSet:
        """Staggered Darcy fluxes of ``S`` as a halo-updated face FieldSet."""
        g = self.grid
        k = (S.phi.data / self.phi0) ** self.npow
        qx, qy, qz = darcy_flux(S.Pe.data, k, self.spacing)
        return flds.update_halo(g, FieldSet(qx=Field(g, qx, "xface"), qy=Field(g, qy, "yface"),
                                            qz=Field(g, qz, "zface")))

    # ------------------------------------------------------------------
    # oracle on the deduplicated global grid
    # ------------------------------------------------------------------
    def oracle(self, nt: int, cg_tol: float = 1e-12):
        """Single-array reference: the same integrator on the gathered global
        grid in f64 (explicit: this app's own single step on one CPU array;
        implicit: backward Euler with an independent NumPy CG).  Returns
        ``(Pe, phi)`` NumPy arrays."""
        S = self.init_fields()
        Pe = flds.gather(S.Pe).astype(np.float64)
        phi = flds.gather(S.phi).astype(np.float64)
        if self.method == "explicit":
            for _ in range(nt):
                Pe_t, phi_t = self._single_step(torch.from_numpy(Pe), torch.from_numpy(phi))
                Pe, phi = Pe_t.numpy(), phi_t.numpy()
            return Pe, phi
        for _ in range(nt):
            Pe, phi = self._np_implicit_step(Pe, phi, cg_tol)
        return Pe, phi

    def _np_implicit_step(self, Pe, phi, cg_tol, maxiter=20000):
        """One backward-Euler step in NumPy (explicit-slicing stencils)."""
        dt, dz = self.dt, self.dz
        h2 = np.asarray(self.spacing, np.float64) ** 2
        inner = (slice(1, -1),) * 3
        k = (phi / self.phi0) ** self.npow
        ie = (self.phi0 / self.eta0) * (phi / self.phi0) ** self.m
        diag = 1.0 / dt + ie
        kz = 0.5 * (k[1:-1, 1:-1, 1:] + k[1:-1, 1:-1, :-1])
        G = np.diff(kz, axis=2) / dz
        b = np.zeros_like(Pe)
        b[inner] = Pe[inner] / dt - G

        def A(u):
            u0 = u[inner]
            k0 = k[inner]
            acc = np.zeros_like(u0)
            for d in range(3):
                sl_p = [slice(1, -1)] * 3
                sl_m = [slice(1, -1)] * 3
                sl_p[d] = slice(2, None)
                sl_m[d] = slice(None, -2)
                kf_p = 0.5 * (k0 + k[tuple(sl_p)])
                kf_m = 0.5 * (k0 + k[tuple(sl_m)])
                acc += (kf_p * (u[tuple(sl_p)] - u0)
                        - kf_m * (u0 - u[tuple(sl_m)])) / h2[d]
            out = np.zeros_like(u)
            out[inner] = diag[inner] * u0 - acc
            return out

        u = Pe.copy()                     # warm start; ring holds the BC (0)
        r = np.zeros_like(b)
        r[inner] = (b - A(u))[inner]
        p = r.copy()
        rs = float((r[inner] ** 2).sum())
        bn = float((b[inner] ** 2).sum()) ** 0.5 or 1.0
        for _ in range(maxiter):
            if rs ** 0.5 <= cg_tol * bn:
                break
            Ap = A(p)
            alpha = rs / float((p[inner] * Ap[inner]).sum())
            u += alpha * p
            r[inner] -= alpha * Ap[inner]
            rs_new = float((r[inner] ** 2).sum())
            p = r + (rs_new / rs) * p
            rs = rs_new
        Pe2 = Pe.copy()
        Pe2[inner] = u[inner]
        phi2 = phi.copy()
        phi2[inner] = np.clip(
            phi[inner] + dt * (1.0 - phi[inner]) * u[inner] * ie[inner],
            1e-4, 0.25)
        return Pe2, phi2

    # ------------------------------------------------------------------
    # bookkeeping: bytes and the paper's T_eff
    # ------------------------------------------------------------------
    def halo_bytes_per_step(self) -> int:
        n = self.dtype.itemsize
        return 2 * 2 * n * (self.nx * self.ny + self.ny * self.nz + self.nx * self.nz)

    def a_eff_per_step(self) -> int:
        """Effective bytes per time step: ``Pe`` and ``phi`` are unknowns (read
        and written); the nonlinear coefficients are derived from them (not
        counted) — ``(2 * 2 + 0) * n_cells * itemsize``."""
        n = int(np.prod(self.grid.global_shape))
        return a_eff(n, n_unknown_fields=2, n_known_fields=0, itemsize=self.dtype.itemsize)

    def t_eff(self, t_step_s: float) -> float:
        """T_eff in GB/s at a measured seconds-per-step."""
        return t_eff(self.a_eff_per_step(), t_step_s)
