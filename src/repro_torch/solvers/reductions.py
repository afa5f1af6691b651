"""Global reductions on the implicit global grid.

The blocks of a field duplicate the ``overlap`` cells shared by
neighbouring blocks, so a plain sum over the field over-counts them.  An
*ownership mask* selects the cells each block owns — its non-halo cells
``[h, n-h)``, which tile the global grid exactly, plus the physical boundary
ring on first/last blocks — so masked dot products and norms are exact: the
convergence-check ``MPI.Allreduce`` of the paper's iterative apps.

Periodic dims change the bookkeeping, not the mechanics: the global ring
planes are wrap duplicates of the opposite interior (``i == i +- (N -
overlap)``), so ownership drops them (each physical cell counted once) and
:func:`interior_mask` pins nothing there.

A process's partial is one sum over all axes of the masked product of its
blocks — the block axes take the place of the reference's ``psum`` over
the mesh within a process.  :func:`psum`, :func:`pmax` and :func:`pmin`
are the reference's three wrappers: they all-reduce the partials across the
processes of a group (:func:`repro_torch.core.comm.all_reduce`; the
identity when one process holds every block), and they are where the
telemetry counts every global reduction
(:mod:`repro_torch.telemetry.counters`).  Floating fields accumulate in
float64 (:func:`acc_dtype`), so f32 solves get faithful stopping tests.
Scalars come back as 0-d tensors on the field's device; reading one on the
host is the caller's choice.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..analysis import markers as _mk
from ..core import comm
from ..core import locations as _loc
from ..telemetry.counters import record_all_reduce as _record_all_reduce


# The three wrappers below are the ONLY all-reduce call sites of the solver
# stack, so the telemetry hook here counts every dot product and
# convergence-test reduction of a solve (one falsy check when nothing
# collects).  With one process the partials already cover every block.

def _all_reduce(topo, x: torch.Tensor, op: str) -> torch.Tensor:
    _record_all_reduce(x.numel())
    if _mk.TRACE is not None:
        # an analyzer check records every global reduction as the
        # collective it is on a group (``comm`` records, sends nothing)
        x = _mk.blessed_reduce(x, op=f"p{op}", site=f"solvers.reductions.p{op}")
        return comm.all_reduce(x, op)
    return comm.all_reduce(x, op) if topo.nprocs > 1 else x


def psum(topo, x: torch.Tensor) -> torch.Tensor:
    """Sum all-reduce of the per-process partials ``x`` (the partials added
    in process order, the same bits on every process)."""
    return _all_reduce(topo, x, "sum")


def pmax(topo, x: torch.Tensor) -> torch.Tensor:
    """Max all-reduce of the per-process partials ``x``."""
    return _all_reduce(topo, x, "max")


def pmin(topo, x: torch.Tensor) -> torch.Tensor:
    """Min all-reduce of the per-process partials ``x``."""
    return _all_reduce(topo, x, "min")


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype for masked reductions: float64 for floating
    fields, the field dtype otherwise."""
    return torch.float64 if dtype.is_floating_point else dtype


def owned_mask(grid, dtype=None) -> torch.Tensor:
    """1.0 on cells each block owns in the deduplicated global grid.

    The non-halo cells plus the physical boundary ring on first/last
    blocks; on a periodic dim the ring planes are wrap duplicates, owned by
    the opposite block's interior, so ring ownership is dropped.  Every
    owned cell is locally computed, so the mask is exact even for fields
    whose halo cells are stale (no halo exchange is needed before reducing).
    """
    dtype = dtype or grid.dtype
    nd, h = grid.ndims, grid.halo
    m = grid.ones(dtype)
    for d in range(nd):
        n = grid.local_shape[d]
        shape = [1] * (2 * nd)
        shape[nd + d] = n
        idx = torch.arange(n, device=grid.device).reshape(shape)
        own = (idx >= h) & (idx < n - h)
        if not grid.topo.periodic[d]:
            coord = grid.topo.coord(d, grid.device)
            own = own | ((coord == 0) & (idx < h)) | ((coord == grid.dims[d] - 1) & (idx >= n - h))
        m = m * own.to(dtype)
    return _mk.mask(m, mask_kind="owned", site="solvers.reductions.owned_mask")


def interior_mask(grid, width: int | None = None, dtype=None) -> torch.Tensor:
    """1.0 on the unknowns: cells not pinned by a Dirichlet boundary.

    On non-periodic dims, the cells strictly inside the global physical
    boundary ring of ``width`` (default: the halo width); periodic dims
    are left unmasked.  ``owned_mask * interior_mask`` counts each unknown
    exactly once.
    """
    dtype = dtype or grid.dtype
    w = grid.halo if width is None else int(width)
    m = grid.ones(dtype)
    gidx = grid.local_global_indices()
    for d in range(grid.ndims):
        if grid.topo.periodic[d]:
            continue
        m = m * ((gidx[d] >= w) & (gidx[d] < grid.n_g(d) - w)).to(dtype)
    return _mk.mask(m, mask_kind="interior", site="solvers.reductions.interior_mask")


def solve_mask(grid, dtype=None) -> torch.Tensor:
    """Reduction mask over the unknowns, each counted exactly once."""
    return owned_mask(grid, dtype) * interior_mask(grid, dtype=dtype)


def loc_solve_mask(grid, loc: str, dtype=None) -> torch.Tensor:
    """Location-aware :func:`solve_mask`: ownership times the location's
    validity and unknown masks."""
    return owned_mask(grid, dtype) * _loc.valid_mask(grid, loc, dtype) \
        * _loc.interior_mask(grid, loc, dtype)


def _partial(a, b, m) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return (a.to(acc) * b.to(acc) * m.to(acc)).sum()


def _leaves(t) -> list:
    """The tensors of a tree: a tensor, a Field, a FieldSet, or a list/tuple
    of them (:func:`repro_torch.core.locations.tree_leaves`)."""
    return _loc.tree_leaves(t)


def masked_mean(grid, a, mask) -> torch.Tensor:
    """Mean of ``a`` over the cells selected by ``mask``, numerator and
    denominator summed together (one reduction), accumulated per
    :func:`acc_dtype`."""
    acc = acc_dtype(a.dtype)
    s = psum(grid.topo, torch.stack([(a.to(acc) * mask.to(acc)).sum(), mask.to(acc).sum()]))
    return s[0] / s[1]


def dot(grid, a, b, mask=None) -> torch.Tensor:
    """Deduplicated global dot product ``<a, b>``, accumulated in float64."""
    if mask is None:
        mask = owned_mask(grid, a.dtype)
    return psum(grid.topo, _partial(a, b, mask))


def tree_dot(grid, a, b, masks) -> torch.Tensor:
    """Deduplicated global dot over trees of fields (a tensor, a Field, a
    FieldSet or a list/tuple, with a structure-matching tree of masks), as
    one reduction: a whole staggered system is one Krylov vector."""
    la, lb, lm = _leaves(a), _leaves(b), _leaves(masks)
    if not (len(la) == len(lb) == len(lm)):
        raise ValueError(f"tree_dot: mismatched leaves — {len(la)}/{len(lb)}/{len(lm)} "
                         "for a/b/masks")
    return psum(grid.topo, sum(_partial(x, y, m) for x, y, m in zip(la, lb, lm)))


def tree_dot_many(grid, pairs, masks) -> tuple[torch.Tensor, ...]:
    """Several deduplicated global dots as ONE stacked sum.

    ``pairs`` is a sequence of ``(a, b)`` pairs sharing the structure of
    ``masks``.  The partial sums are stacked into one tensor and reduced by
    ONE :func:`psum` carrying e.g. ``<r, z>``, ``<w, u>`` and ``||r||^2`` at
    once.  Returns one 0-d tensor per pair.
    """
    lm = _leaves(masks)
    partials = []
    for i, (a, b) in enumerate(pairs):
        la, lb = _leaves(a), _leaves(b)
        if not (len(la) == len(lb) == len(lm)):
            raise ValueError(f"tree_dot_many: mismatched leaves in pair {i} — "
                             f"{len(la)}/{len(lb)}/{len(lm)} for a/b/masks")
        partials.append(sum(_partial(x, y, m) for x, y, m in zip(la, lb, lm)))
    s = psum(grid.topo, torch.stack(partials))
    return tuple(s.unbind())


def tree_rhs_norm(grid, b, masks) -> torch.Tensor:
    """``||b||`` over trees of fields with the zero-rhs guard."""
    bn = torch.sqrt(tree_dot(grid, b, b, masks))
    return torch.where(bn > 0, bn, torch.ones_like(bn))


def rhs_norm(grid, b, mask) -> torch.Tensor:
    """``||b||`` for relative-residual tests, guarded so a zero rhs yields 1
    (absolute residuals) instead of a 0/0 in the convergence test."""
    return tree_rhs_norm(grid, b, mask)


def norm_l2(grid, a, mask=None) -> torch.Tensor:
    """Deduplicated global L2 norm."""
    return torch.sqrt(dot(grid, a, a, mask))


def norm_linf(grid, a, mask=None) -> torch.Tensor:
    """Deduplicated global max-abs norm."""
    if mask is None:
        mask = owned_mask(grid, a.dtype)
    return pmax(grid.topo, (a.abs() * mask).max())


def field_min(grid, a, mask=None) -> torch.Tensor:
    """Deduplicated global minimum."""
    if mask is None:
        mask = owned_mask(grid, a.dtype)
    return pmin(grid.topo, torch.where(mask > 0, a, torch.finfo(a.dtype).max).min())


def field_max(grid, a, mask=None) -> torch.Tensor:
    """Deduplicated global maximum."""
    if mask is None:
        mask = owned_mask(grid, a.dtype)
    return pmax(grid.topo, torch.where(mask > 0, a, torch.finfo(a.dtype).min).max())


# ---------------------------------------------------------------------------
# host-level forms: a local-view reduction already reduces over every block
# and process; these keep the reference's names
# ---------------------------------------------------------------------------

def host_reduce(grid, fn: Callable, *fields) -> torch.Tensor:
    """Run a reduction ``fn(*fields) -> scalar`` over grid fields."""
    return fn(*fields)


def dot_g(grid, A, B) -> torch.Tensor:
    """Host-level deduplicated global dot product of two grid fields."""
    return dot(grid, A, B)


def norm_l2_g(grid, A) -> torch.Tensor:
    """Host-level deduplicated global L2 norm of a grid field."""
    return norm_l2(grid, A)


def norm_linf_g(grid, A) -> torch.Tensor:
    """Host-level deduplicated global Linf norm of a grid field."""
    return norm_linf(grid, A)


def field_min_g(grid, A) -> torch.Tensor:
    """Host-level deduplicated global minimum of a grid field."""
    return field_min(grid, A)


def field_max_g(grid, A) -> torch.Tensor:
    """Host-level deduplicated global maximum of a grid field."""
    return field_max(grid, A)

