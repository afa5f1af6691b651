"""The implicit global grid — the paper's core abstraction.

The user writes a single-device stencil code on a local grid of shape
``(nx, ny, nz)`` (halo cells included).  The global grid follows from the
block counts ``dims`` of a Cartesian topology:

    nx_g = dims_x * (nx - overlap) + overlap        (overlap = 2 * halo)

``dims`` are the global block counts.  Without a ``torch.distributed``
group one process holds every block: a *field* is one contiguous tensor of
shape ``(*dims, *local_shape)``, all ``prod(dims)`` blocks virtual ranks on
the same device, each block contiguous like a real rank's memory,
neighbouring blocks logically overlapping.  Under a group of ``P``
processes the blocks are spread over them (:mod:`.topology`): each process
holds the box of ``local_dims`` blocks its coordinate in the process
layout ``procs`` gives it, and its field tensor is ``(*local_dims,
*local_shape)``; halos cross processes by point-to-point messages and
reductions by all-reduces (:mod:`.comm`).  ``dims=None`` is one block per
process.  Local-view functions act on the trailing ``ndims`` axes with the
block axes as a batch (``vmap`` written out), so ``parallel`` is a plain
call.  The reference's storage layout, one array of stacked blocks
(``stacked_shape``), is reached through :meth:`to_stacked` /
:meth:`from_stacked`; these and :meth:`gather` / :meth:`scatter` see the
whole grid on every process.

Three calls turn a single-device solver into a multi-block one, as in the
paper's Fig. 1:

    grid = init_global_grid(nx, ny, nz, dims=...)  # 1. implicit global grid
    ...  grid.update_halo(T2) / grid.hide(...)      # 2. halo update
    grid.finalize()                                 # 3. finalize
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .._device import resolve_device
from . import comm
from . import halo as _halo
from . import hide as _hide
from .topology import CartesianTopology, dims_create, procs_for


class ImplicitGlobalGrid:
    """Implicit global grid over ``prod(dims)`` blocks, held by this process
    alone or spread over the processes of the default ``torch.distributed``
    group in the process layout :func:`procs_for` gives."""

    def __init__(
        self,
        nx: int,
        ny: int | None = 1,
        nz: int | None = 1,
        *,
        overlap: int = 2,
        periodic: Sequence[bool] = (False, False, False),
        dims: Sequence[int] | None = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        local = [n for n in (nx, ny, nz) if n is not None]
        self.ndims = len(local)
        self.local_shape = tuple(int(n) for n in local)
        if overlap % 2 != 0:
            raise ValueError("overlap must be even (two halo layers of width h)")
        self.overlap = int(overlap)
        self.halo = self.overlap // 2
        nprocs = comm.world_size()
        if dims is None:
            dims = dims_create(nprocs, self.ndims)  # one block per process
        dims = tuple(int(d) for d in dims)
        if len(dims) != self.ndims:
            raise ValueError(f"dims {dims} do not match grid rank {self.ndims}")
        procs = procs_for(dims, nprocs)
        self.topo = CartesianTopology(
            dims=dims, periodic=tuple(bool(p) for p in periodic[: self.ndims]), procs=procs,
            pcoord=tuple(int(c) for c in np.unravel_index(comm.rank(), procs)))
        self.dtype = dtype
        self.device = resolve_device(device)
        for n in self.local_shape:
            if n <= self.overlap:
                raise ValueError(f"local extent {n} must exceed overlap {self.overlap}")

    # ------------------------------------------------------------------
    # sizes & coordinates (paper: nx_g(), x_g(), ...)
    # ------------------------------------------------------------------
    @property
    def dims(self) -> tuple[int, ...]:
        """Global block counts."""
        return self.topo.dims

    @property
    def local_dims(self) -> tuple[int, ...]:
        """Block counts this process holds (``dims`` without a group)."""
        return self.topo.local_dims

    @property
    def distributed(self) -> bool:
        """True when the blocks are spread over more than one process."""
        return self.topo.nprocs > 1

    def n_g(self, dim: int) -> int:
        n = self.local_shape[dim]
        return self.dims[dim] * (n - self.overlap) + self.overlap

    def nx_g(self) -> int:
        return self.n_g(0)

    def ny_g(self) -> int:
        return self.n_g(1)

    def nz_g(self) -> int:
        return self.n_g(2)

    @property
    def global_shape(self) -> tuple[int, ...]:
        """True global grid shape (deduplicated)."""
        return tuple(self.n_g(d) for d in range(self.ndims))

    def span(self, dim: int) -> int:
        """Domain span of ``dim`` in cells: ``N - 1`` node intervals bracket a
        Dirichlet dim; a periodic dim covers its ``N - overlap`` unique
        cells per period (the ring planes are wrap duplicates)."""
        n = self.n_g(dim)
        return n - self.overlap if self.topo.periodic[dim] else n - 1

    @property
    def stacked_shape(self) -> tuple[int, ...]:
        """Shape of the reference's stacked-blocks array."""
        return tuple(self.dims[d] * self.local_shape[d] for d in range(self.ndims))

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of this process's field tensor: ``(*local_dims, *local_shape)``."""
        return tuple(self.local_dims) + tuple(self.local_shape)

    @property
    def full_shape(self) -> tuple[int, ...]:
        """Shape of the field tensor of every block: ``(*dims, *local_shape)``."""
        return tuple(self.dims) + tuple(self.local_shape)

    def local_global_indices(self) -> tuple[torch.Tensor, ...]:
        """Global index tensors of every block of this process, each shaped
        to broadcast against a field (block axis and local axis of its dim,
        ones elsewhere)."""
        out = []
        nd = self.ndims
        for d in range(nd):
            n = self.local_shape[d]
            shape = [1] * (2 * nd)
            shape[nd + d] = n
            g = self.topo.coord(d, self.device) * (n - self.overlap) \
                + torch.arange(n, device=self.device).reshape(shape)
            out.append(g)
        return tuple(out)

    # ------------------------------------------------------------------
    # field allocation (paper: @zeros, @ones)
    # ------------------------------------------------------------------
    def zeros(self, dtype=None):
        return torch.zeros(self.shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, dtype=None):
        return torch.ones(self.shape, dtype=dtype or self.dtype, device=self.device)

    def full(self, value, dtype=None):
        return torch.full(self.shape, value, dtype=dtype or self.dtype, device=self.device)

    def from_global_fn(self, fn: Callable, dtype=None):
        """Field initialised as ``fn(ix, iy, iz)`` of *global* indices."""
        v = torch.as_tensor(fn(*self.local_global_indices()), device=self.device)
        return v.to(dtype or self.dtype).broadcast_to(self.shape).contiguous()

    def coords(self, dim: int, spacing: float = 1.0, origin: float = 0.0):
        """Global coordinate field along ``dim`` (broadcast to field shape)."""
        return self.from_global_fn(lambda *idx: origin + spacing * idx[dim])

    # ------------------------------------------------------------------
    # local-view execution
    # ------------------------------------------------------------------
    def parallel(self, fn: Callable) -> Callable:
        """Decorator kept for readers of the paper's code: local-view
        functions already act on every block at once (block axes are a
        batch), so this is a plain call."""
        return fn

    def update_halo(self, *arrays, width: int | None = None, dims=None):
        """Paper's ``update_halo!`` (in place; returns the tensors)."""
        return _halo.update_halo(
            self.topo, *arrays, width=self.halo if width is None else width, dims=dims)

    def hide(self, step_fn, inputs, width=(16, 2, 2)):
        """Paper's ``@hide_communication``."""
        return _hide.hide_communication(
            self.topo, step_fn, inputs, width=width[: self.ndims], halo=self.halo)

    def update_halo_g(self, A):
        """Host-level halo update of a whole field (same as
        :meth:`update_halo` here: every call is host-level)."""
        return _halo.update_halo(self.topo, A, width=self.halo)

    # ------------------------------------------------------------------
    # layout conversion, gather / scatter (tests, IO, checkpoints)
    # ------------------------------------------------------------------
    def all_blocks(self, A: torch.Tensor) -> torch.Tensor:
        """Field -> the field tensor of every block, ``(*dims, *local)``
        (``A`` itself without a group).  Collective under a group: every
        process calls it and gets the whole, on the host unless the
        backend moves device tensors."""
        if tuple(A.shape) != self.shape:
            raise ValueError(f"expected a field of shape {self.shape}, got {tuple(A.shape)}")
        if not self.distributed:
            return A
        parts = comm.all_gather(A)
        out = parts[0].new_empty(self.full_shape)
        for r, part in enumerate(parts):
            pc = np.unravel_index(r, self.topo.procs)
            out[tuple(slice(c * n, (c + 1) * n)
                      for c, n in zip(pc, self.local_dims))] = part
        return out

    def to_stacked(self, A: torch.Tensor) -> np.ndarray:
        """Field -> the reference's stacked-blocks NumPy array of the whole
        grid (collective under a group, see :meth:`all_blocks`)."""
        nd = self.ndims
        A = self.all_blocks(A)
        perm = [p for d in range(nd) for p in (d, nd + d)]
        a = A.detach().permute(perm).reshape(self.stacked_shape)
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()

    def _from_own_stacked(self, a, dtype=None) -> torch.Tensor:
        """This process's blocks, stacked as the reference stacks them
        (``local_dims[d] * local_shape[d]`` per dim) -> field tensor."""
        nd = self.ndims
        split = [s for d in range(nd) for s in (self.local_dims[d], self.local_shape[d])]
        perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(split).permute(perm)
        return t.to(device=self.device, dtype=dtype or self.dtype).contiguous()

    def from_stacked(self, a, dtype=None) -> torch.Tensor:
        """Stacked-blocks array of the whole grid (the reference's layout)
        -> this process's field tensor."""
        a = np.asarray(a)
        if a.shape != self.stacked_shape:
            raise ValueError(f"expected {self.stacked_shape}, got {a.shape}")
        if self.distributed:
            a = a[tuple(slice(o * n, (o + m) * n) for o, m, n in
                        zip(self.topo.offset, self.local_dims, self.local_shape))]
        return self._from_own_stacked(a, dtype)

    def gather(self, A: torch.Tensor) -> np.ndarray:
        """Reconstruct the deduplicated global field as a NumPy array (on
        every process; collective under a group)."""
        a = self.to_stacked(A)
        ol = self.overlap
        for d in range(self.ndims):
            D = self.dims[d]
            n = self.local_shape[d]

            def idx(s, d=d):
                return (slice(None),) * d + (s,)

            parts = [a[idx(slice(0, n))]]
            parts += [a[idx(slice(b * n + ol, (b + 1) * n))] for b in range(1, D)]
            a = np.concatenate(parts, axis=d)
        return a

    def scatter(self, G, dtype=None) -> torch.Tensor:
        """Inverse of :meth:`gather`: build the field from a global array
        (every process passes the whole array and takes its blocks)."""
        G = np.asarray(G)
        if G.shape != self.global_shape:
            raise ValueError(f"expected {self.global_shape}, got {G.shape}")
        a = G
        for d in range(self.ndims):
            o, D = self.topo.offset[d], self.local_dims[d]
            n = self.local_shape[d]
            stride = n - self.overlap

            def idx(s, d=d):
                return (slice(None),) * d + (s,)

            a = np.concatenate(
                [a[idx(slice(b * stride, b * stride + n))] for b in range(o, o + D)], axis=d)
        return self._from_own_stacked(a, dtype=dtype)

    # ------------------------------------------------------------------
    # grid hierarchy (geometric multigrid support)
    # ------------------------------------------------------------------
    def can_coarsen(self) -> bool:
        """True if every local interior extent halves evenly (see coarsen)."""
        return all((n - self.overlap) % 2 == 0 and (n - self.overlap) >= 4
                   for n in self.local_shape)

    def coarsen(self) -> "ImplicitGlobalGrid":
        """One-level-coarser grid with the same block counts, process
        layout (every level has the same owners), periodicity, halo width,
        dtype and device.

        Each local interior extent (``n - overlap``) halves, so the global
        interior cell count halves per dim (cell-centered coarsening) and
        ``update_halo`` works identically at every level.
        """
        coarse = []
        for n in self.local_shape:
            inner = n - self.overlap
            if inner % 2 != 0:
                raise ValueError(f"local interior extent {inner} must be even to coarsen")
            if inner < 4:
                raise ValueError(f"local interior extent {inner} too small to coarsen")
            coarse.append(inner // 2 + self.overlap)
        coarse += [None] * (3 - len(coarse))  # the constructor drops None dims
        return ImplicitGlobalGrid(*coarse, overlap=self.overlap, periodic=self.topo.periodic,
                                  dims=self.dims, dtype=self.dtype,
                                  device=self.device)

    def hierarchy(self, max_levels: int | None = None) -> list["ImplicitGlobalGrid"]:
        """Fine-to-coarse grid hierarchy, coarsening while possible."""
        levels = [self]
        while levels[-1].can_coarsen() and (max_levels is None or len(levels) < max_levels):
            levels.append(levels[-1].coarsen())
        return levels

    def finalize(self):
        """Paper's ``finalize_global_grid()``: waits for the device and, under
        a group, for every process.  Eager PyTorch keeps no compiled
        executables to release, and the group stays the caller's: it was
        made and is destroyed outside the grid."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        comm.barrier()


def init_global_grid(nx, ny=1, nz=1, **kw) -> ImplicitGlobalGrid:
    """Paper-faithful alias for constructing the implicit global grid."""
    return ImplicitGlobalGrid(nx, ny, nz, **kw)
