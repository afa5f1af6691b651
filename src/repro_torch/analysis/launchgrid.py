"""Rule family 3: launch plans of the hand-written kernels.

The reference's BlockSpec rule (``repro.analysis.blockspec``) proves each
``pallas_call``'s block mappings over its launch grid.  A CUDA kernel has
no BlockSpec: its grid and block come from the launcher and its
block -> cell map is index arithmetic in the kernel.  Each kernel module
therefore describes its launch as a :class:`LaunchPlan` — the numbers the
launch uses (K1-K5: the wrapper passes ``plan.grid`` and ``plan.block`` to
the C entry point, which refuses a block it was not compiled for; K6, K7:
``chip_smoke.py`` compares the plan with the C entry point's own at every
shape it launches) and the block -> tile map the kernel computes, written
over index arrays.  The rule enumerates the whole launch grid (NumPy,
nothing launched) and proves, per dimension of the output index space:

* **divisibility or guard** — the extent is a multiple of the tile, or
  the kernel skips the cells past it;
* **range** — every mapped tile index lands in ``[0, n_tiles)``;
* **output identity** — every output tile is written by exactly one
  block (a shifted or duplicated output map scatters blocks over each
  other's slots; a hole leaves output unwritten);
* **input shape** — an input map is the output map or a constant shift
  of it modulo the tile count (a true neighbour/wrap read); a non-uniform
  shift with duplicated reads is the clamped-neighbour signature;
* **broadcast honesty** — a map that sends every block to one tile is
  only legal when that dimension has a single tile;
* **launch limits** — grid y/z at most 65535, x at most 2^31 - 1,
  at most 1024 threads per block.

Findings keep the reference rule's name, so reports compare across the
two packages.  Neighbour indices inside a tile (the stencil's reads) stay
with the card's kernel-vs-plain checks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .findings import Finding

RULE = "pallas-blockspec"
_GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``grid`` and ``block`` as launched (x, y, z), the
    output index space ``shape``, the cells per block ``tile`` along each
    of its dims, ``guard[d]`` whether the kernel skips cells past
    ``shape[d]``, and ``out_map(gx, gy, gz)`` -> the tile index along each
    dim of ``shape`` (index arrays in, index arrays out).  ``in_maps`` are
    ``(role, map)`` pairs of inputs read by tile."""

    kernel: str
    grid: tuple
    block: tuple
    shape: tuple
    tile: tuple
    guard: tuple
    out_map: Callable = dataclasses.field(compare=False, repr=False)
    in_maps: tuple = dataclasses.field(default=(), compare=False, repr=False)

    def tiles(self) -> tuple:
        return tuple(-(-n // t) for n, t in zip(self.shape, self.tile))


def _dupes(out_d, in_d) -> int:
    pairs = np.unique(np.stack([out_d, in_d]), axis=1)
    return len(np.unique(pairs[0])) - len(np.unique(pairs[1]))


def check_plan(plan: LaunchPlan, site: str = "") -> list[Finding]:
    where = f"{site}/{plan.kernel}" if site else plan.kernel
    out: list[Finding] = []

    def err(role, msg):
        out.append(Finding(RULE, "error", f"{where}/{role}", msg))

    grid = tuple(int(g) for g in plan.grid) + (1,) * (3 - len(plan.grid))
    for a, (g, lim) in enumerate(zip(grid, _GRID_LIMITS)):
        if not 1 <= g <= lim:
            err("grid", f"grid dimension {'xyz'[a]} = {g} outside [1, {lim}]")
    if math.prod(plan.block) > 1024 or min(plan.block) < 1:
        err("grid", f"block {tuple(plan.block)} is not a valid thread block (1..1024 threads)")
    if out:
        return out
    nbs = plan.tiles()
    for d, (n, t) in enumerate(zip(plan.shape, plan.tile)):
        if n % t and not plan.guard[d]:
            err("out", f"block extent {t} does not tile dim {d} of the output shape "
                       f"{tuple(plan.shape)} and the kernel does not guard it — the trailing "
                       "partial block reads/writes out of bounds")
    gx, gy, gz = (a.ravel() for a in np.meshgrid(*(np.arange(g) for g in grid), indexing="ij"))
    o = [np.asarray(a) + np.zeros_like(gx) for a in plan.out_map(gx, gy, gz)]
    bad = [(d, a[(a < 0) | (a >= nb)]) for d, (a, nb) in enumerate(zip(o, nbs))]
    for d, b in bad:
        if b.size:
            err("out", f"dim {d} (block count {nbs[d]}): block index {int(b[0])} out of range "
                       f"[0, {nbs[d]}) — reads/writes outside the array")
    if any(b.size for _, b in bad):
        return out
    total = math.prod(nbs)
    counts = np.bincount(np.ravel_multi_index(o, nbs), minlength=total)
    if total > 1 and counts.max() == gx.size:
        blk = np.unravel_index(int(counts.argmax()), nbs)
        err("out", f"every grid step maps to block {tuple(int(i) for i in blk)} of {nbs} — "
                   "all instances touch the same slab")
    elif counts.max() > 1:
        err("out", f"output map is not the identity — {int((counts > 1).sum())} output "
                   "block(s) written by more than one grid step (shifted outputs scatter "
                   "blocks over each other's slots)")
    elif counts.min() == 0:
        err("out", f"the launch covers {int((counts > 0).sum())} of {total} output blocks — "
                   "the rest of the output is never written")
    for role, fn in plan.in_maps:
        m = [np.asarray(a) + np.zeros_like(gx) for a in fn(gx, gy, gz)]
        for d, (a, nb) in enumerate(zip(m, nbs)):
            if ((a < 0) | (a >= nb)).any():
                v = int(a[(a < 0) | (a >= nb)][0])
                err(role, f"dim {d} (block count {nb}): block index {v} out of range "
                          f"[0, {nb}) — reads outside the array")
                continue
            if nb > 1 and (a == a[0]).all() and not (o[d] == o[d][0]).all():
                err(role, f"dim {d} (block count {nb}): every grid step maps to block "
                          f"{int(a[0])} of {nb} — all instances touch the same slab")
                continue
            if len(np.unique((a - o[d]) % nb)) > 1:
                k = _dupes(o[d], a)
                err(role, f"dim {d} (block count {nb}): " + (
                    f"non-uniform shift with {k} duplicated block read(s) — the "
                    "clamped-neighbor signature (a boundary block's ghost row aliases its own "
                    "edge row instead of the wrap row the reference reads); use (i +- 1) mod nb"
                    if k else "index map is neither the identity nor a constant shift mod nb"))
    return out


def run(trace) -> list[Finding]:
    findings: list[Finding] = []
    seen = set()
    for plan in trace.launches:
        key = (plan.kernel, plan.grid, plan.block, plan.shape)
        if key not in seen:
            seen.add(key)
            findings.extend(check_plan(plan))
    return findings


def check_kernel_library(sms: int = 132) -> list[Finding]:
    """Every kernel's launch plan at the main path's shapes and the
    tests' shapes (``kernels.library_plans``), checked without launching."""
    from ..kernels.plans import library_plans
    findings: list[Finding] = []
    for label, plan in library_plans(sms):
        findings.extend(check_plan(plan, label))
    return findings
