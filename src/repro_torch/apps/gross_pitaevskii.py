"""Paper ref [4]: nonlinear Gross-Pitaevskii quantum fluid solver.

    i dpsi/dt = [-1/2 laplacian + V(x) + g |psi|^2] psi

advanced with classic RK4 in time and centered differences in space, on
the implicit global grid, with a halo update of the complex field after
every stage.  It shows that the halo machinery does not depend on the
field dtype: ``torch.complex64`` blocks travel through
:func:`repro_torch.core.halo.update_halo` as any real field does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import init_global_grid
from ..stencil import fd3d as fd


@dataclasses.dataclass
class GrossPitaevskii3D:
    nx: int = 32
    ny: int = 32
    nz: int = 32
    g_int: float = 0.5          # interaction strength
    lx: float = 12.0
    trap: float = 0.5           # harmonic trap strength
    hide: tuple | None = None   # kept for the reference's signature; unused (complex
                                # halos go through plain update_halo)
    dims: tuple | None = None   # global blocks per dim (None: one per process)
    device: object = None       # None: the CUDA card

    def __post_init__(self):
        self.grid = init_global_grid(self.nx, self.ny, self.nz, dims=self.dims,
                                     dtype=torch.complex64, device=self.device)
        g = self.grid
        self.dx = self.lx / (g.nx_g() - 1)
        # RK4 stability for i dpsi/dt = H psi: |lambda_max * dt| < 2.8 with
        # lambda_max ~ kinetic (3/dx^2) + trap potential at the corner + g
        lam = 3.0 / self.dx ** 2 + 0.5 * self.trap * 3 * (self.lx / 2) ** 2 + self.g_int
        self.dt = 2.0 / lam
        dx, dt, g_int, trap, lx = self.dx, self.dt, self.g_int, self.trap, self.lx

        def V_fn(ix, iy, iz):
            x = ix * dx - lx / 2
            y = iy * dx - lx / 2
            z = iz * dx - lx / 2
            return 0.5 * trap * (x ** 2 + y ** 2 + z ** 2)

        # the potential on every block (global coordinates), float32
        self._V = g.from_global_fn(V_fn, dtype=torch.float32)

        def rhs(psi, V):
            """-i H psi on interior points; zeros on the ring."""
            lap = (fd.d2_xi(psi) + fd.d2_yi(psi) + fd.d2_zi(psi)) / dx ** 2
            p = fd.inn(psi)
            r = (-1j) * (-0.5 * lap + (fd.inn(V) + g_int * torch.abs(p) ** 2) * p)
            out = torch.zeros_like(psi)
            out[..., 1:-1, 1:-1, 1:-1] = r.to(psi.dtype)
            return out

        def rk4(psi, V, upd):
            """Classic RK4; ``upd`` refreshes halos between stages."""
            k1 = rhs(psi, V)
            k2 = rhs(upd(psi + 0.5 * dt * k1), V)
            k3 = rhs(upd(psi + 0.5 * dt * k2), V)
            k4 = rhs(upd(psi + dt * k3), V)
            return upd(psi + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))

        self._step = lambda psi, V: rk4(psi, V, g.update_halo)
        self._single_step = lambda psi, V: rk4(psi, V, lambda a: a)

    def init_fields(self):
        g = self.grid
        dx, lx = self.dx, self.lx

        def psi_fn(ix, iy, iz):
            x = ix * dx - lx / 2
            y = iy * dx - lx / 2
            z = iz * dx - lx / 2
            r2 = x ** 2 + y ** 2 + z ** 2
            return torch.exp(-r2 / 4.0)

        return g.from_global_fn(psi_fn, dtype=torch.complex64)

    def norm(self, psi) -> float:
        G = self.grid.gather(psi)
        return float(np.sum(np.abs(G) ** 2) * self.dx ** 3)

    def run(self, nt: int, psi=None):
        if psi is None:
            psi = self.init_fields()
        for _ in range(nt):
            psi = self._step(psi, self._V)
        if psi.device.type == "cuda":
            torch.cuda.synchronize(psi.device)
        return psi

    def oracle(self, nt: int) -> np.ndarray:
        """The single-block step on the gathered global field (the same
        device and dtype), as a NumPy array."""
        g = self.grid
        psi = torch.as_tensor(g.gather(self.init_fields()), device=g.device)
        V = torch.as_tensor(g.gather(self._V), device=g.device)
        for _ in range(nt):
            psi = self._single_step(psi, V)
        return psi.cpu().numpy()
