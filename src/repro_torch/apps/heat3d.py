"""Paper Fig. 1: stencil-based 3-D heat diffusion solver.

Three grid calls turn the single-block solver into a multi-block one:

    grid = init_global_grid(nx, ny, nz, dims=...)   (line 23 of Fig. 1)
    ...   update_halo / hide_communication          (line 38 / 36)
    grid.finalize()                                 (line 43)

The whole compute of a step is one heat-step kernel launch per block batch:
one for the full field without hiding, seven with it (six boundary-shell
slabs and the interior), in each process of a ``torch.distributed`` group
over the blocks it holds.  :meth:`Heat3D.oracle` takes gathered global
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import init_global_grid
from ..kernels.stencil3d.ops import heat_step
from .. import telemetry as tele
from ..telemetry import a_eff, t_eff


@dataclasses.dataclass
class Heat3D:
    nx: int = 32
    ny: int = 32
    nz: int = 32
    lam: float = 1.0
    c0: float = 2.0
    lx: float = 1.0
    hide: tuple | None = (16, 2, 2)   # paper's @hide_communication tuple
    use_kernel: str = "auto"          # auto | cuda | ref
    dims: tuple | None = None         # global blocks per dim (None: one per process)
    dtype: torch.dtype = torch.float32
    device: object = None             # None: the CUDA card
    heartbeat: int = 0                # rank-0 heartbeat event every k solver iterations
    flight_dir: str | None = None     # per-rank flight-record dump directory

    def __post_init__(self):
        self.grid = init_global_grid(self.nx, self.ny, self.nz, dims=self.dims,
                                     dtype=self.dtype, device=self.device)
        g = self.grid
        self.dx = self.lx / (g.nx_g() - 1)
        self.dy = self.lx / (g.ny_g() - 1)
        self.dz = self.lx / (g.nz_g() - 1)
        self.dt = min(self.dx, self.dy, self.dz) ** 2 / self.lam / (1.0 / self.c0) / 6.1

        lam, dt, dx, dy, dz = self.lam, self.dt, self.dx, self.dy, self.dz

        def step(T, Ci):
            return heat_step(T, Ci, lam, dt, dx, dy, dz, use_kernel=self.use_kernel)

        if self.hide is not None:
            # clamp the shell width so 2*(w+h) fits the local extent
            local = g.local_shape
            hide = tuple(max(1, min(w, local[d] // 2 - 1)) for d, w in enumerate(self.hide))

            def dstep(T, Ci):
                return g.hide(step, (T, Ci), width=hide)
        else:
            hide = None

            def dstep(T, Ci):
                return g.update_halo(step(T, Ci))

        self._step = dstep
        self._hide_widths = hide

    def init_fields(self):
        g = self.grid
        return g.full(1.7), g.full(1.0 / self.c0)

    def run(self, nt: int, T=None, Ci=None):
        if T is None:
            T, Ci = self.init_fields()
        with self._observe(), tele.region("heat3d.run", nt=nt, sync=lambda: T):
            for _ in range(nt):
                T = self._step(T, Ci)
            if T.device.type == "cuda":
                torch.cuda.synchronize(T.device)
        return T, Ci

    def _observe(self):
        """Runtime observability per the app's ``heartbeat``/``flight_dir``
        fields (reentrant no-op when both are off/outer-installed)."""
        return tele.observe(heartbeat=self.heartbeat, flight_dir=self.flight_dir,
                            meta={"app": "heat3d", "dims": self.grid.dims})

    def oracle(self, nt: int, T=None, Ci=None) -> np.ndarray:
        """Single-array f64 NumPy reference on the deduplicated global grid,
        from global arrays ``T``/``Ci`` (default: the app's constant start,
        as in :meth:`init_fields`)."""
        g = self.grid
        G = np.full(g.global_shape, 1.7) if T is None else np.array(T, np.float64)
        ci = 1.0 / self.c0 if Ci is None else np.asarray(Ci, np.float64)[1:-1, 1:-1, 1:-1]
        a = self.dt * self.lam * ci
        for _ in range(nt):
            inn = G[1:-1, 1:-1, 1:-1]
            G2 = G.copy()
            G2[1:-1, 1:-1, 1:-1] = inn + a * (
                (G[2:, 1:-1, 1:-1] - 2 * inn + G[:-2, 1:-1, 1:-1]) / self.dx ** 2
                + (G[1:-1, 2:, 1:-1] - 2 * inn + G[1:-1, :-2, 1:-1]) / self.dy ** 2
                + (G[1:-1, 1:-1, 2:] - 2 * inn + G[1:-1, 1:-1, :-2]) / self.dz ** 2
            )
            G = G2
        return G

    # --- roofline bookkeeping (memory-bound stencil) --------------------
    def bytes_per_step_per_cell(self) -> int:
        # read T (7 points but perfect reuse -> 1x), read Ci, write T2
        return 3 * self.dtype.itemsize

    def halo_bytes_per_step(self) -> int:
        """Bytes sent per block per halo update (6 faces, width 1)."""
        n = self.dtype.itemsize
        return 2 * n * (self.nx * self.ny + self.ny * self.nz + self.nx * self.nz)

    # --- paper's T_eff convention --------------------------------------
    def a_eff_per_step(self) -> int:
        """Effective bytes per time step: T read and written, Ci read once,
        ``(2 * 1 + 1) * n_cells * itemsize`` over the global grid."""
        n = int(np.prod(self.grid.global_shape))
        return a_eff(n, n_unknown_fields=1, n_known_fields=1, itemsize=self.dtype.itemsize)

    def t_eff(self, t_step_s: float) -> float:
        """T_eff in GB/s at a measured seconds-per-step."""
        return t_eff(self.a_eff_per_step(), t_step_s)
