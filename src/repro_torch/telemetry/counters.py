"""Communication counters of the live solve.

The instrumented call sites are :func:`repro_torch.core.halo.update_halo`
(one record per array and exchanged grid dimension) and the ``psum`` /
``pmax`` / ``pmin`` wrappers of :mod:`repro_torch.solvers.reductions` (one
record per global reduction).  With no collector installed each hook is
one falsy check.

The reference counts one abstract trace of a compiled solve.  The port's
loops run in Python, so it counts the solve as it runs: the solvers wrap
their loop bodies in :func:`tag` (``"iteration"``, and ``"replacement"``
for pipelined CG's residual-replacement heads), and a collector keeps

* ``buckets`` — everything recorded under each tag over the whole run
  (``"setup"`` for what lies outside every tag), whose sum is the live
  grand total (:meth:`_Collector.total`);
* ``first`` — the counts of the FIRST occurrence of each tag, which
  become ``per_iteration`` / ``per_replacement`` of :class:`CommStats`.

``CommStats.totals(k, replacements)`` then predicts the whole solve; it
equals the live grand total exactly when every iteration communicates the
same, which the tests check.

All byte counts are PER RANK: a block sends ``2 * halo * prod(face) *
itemsize`` bytes per exchanged dim (both directions), the analytic
halo-volume formula.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math


@dataclasses.dataclass
class CounterSnapshot:
    """Communication counts of one bucket (setup, or one loop iteration)."""

    halo_exchanges: int = 0          # per-dim, per-array exchange events
    halo_bytes: int = 0              # bytes sent per rank (both directions)
    halo_per_dim: dict = dataclasses.field(default_factory=dict)
    all_reduces: int = 0             # psum/pmax/pmin calls
    all_reduce_scalars: int = 0      # scalars carried by those reductions

    def add_halo(self, dim: int, nbytes: int):
        self.halo_exchanges += 1
        self.halo_bytes += nbytes
        d = self.halo_per_dim.setdefault(dim, {"exchanges": 0, "bytes": 0})
        d["exchanges"] += 1
        d["bytes"] += nbytes

    def add_all_reduce(self, scalars: int):
        self.all_reduces += 1
        self.all_reduce_scalars += scalars

    def scaled_sum(self, other: "CounterSnapshot", factor: int) -> "CounterSnapshot":
        """``self + factor * other`` (for setup + iters * per_iteration)."""
        out = CounterSnapshot(
            halo_exchanges=self.halo_exchanges + factor * other.halo_exchanges,
            halo_bytes=self.halo_bytes + factor * other.halo_bytes,
            all_reduces=self.all_reduces + factor * other.all_reduces,
            all_reduce_scalars=self.all_reduce_scalars + factor * other.all_reduce_scalars,
        )
        for src, mult in ((self.halo_per_dim, 1), (other.halo_per_dim, factor)):
            for dim, d in src.items():
                o = out.halo_per_dim.setdefault(dim, {"exchanges": 0, "bytes": 0})
                o["exchanges"] += mult * d["exchanges"]
                o["bytes"] += mult * d["bytes"]
        return out

    def as_dict(self) -> dict:
        return {
            "halo_exchanges": self.halo_exchanges,
            "halo_bytes": self.halo_bytes,
            "halo_per_dim": {str(k): dict(v) for k, v in sorted(self.halo_per_dim.items())},
            "all_reduces": self.all_reduces,
            "all_reduce_scalars": self.all_reduce_scalars,
        }


@dataclasses.dataclass
class CommStats:
    """Per-solve communication stats attached to ``SolveInfo.comm``.

    ``setup`` covers everything outside the solver's iteration loop
    (initial residual, preconditioner setup, final halo refresh);
    ``per_iteration`` is one loop body.  ``per_replacement`` is one
    residual-replacement segment head (pipelined CG recomputes ``r = b -
    A x`` exactly every ``replace_every`` iterations; empty for solvers
    without replacement).  ``totals(k, nrep)`` gives the whole solve at
    ``k`` iterations and ``nrep`` replacements.
    """

    setup: CounterSnapshot
    per_iteration: CounterSnapshot
    per_replacement: CounterSnapshot = dataclasses.field(default_factory=CounterSnapshot)

    def totals(self, iterations: int, replacements: int = 0) -> CounterSnapshot:
        out = self.setup.scaled_sum(self.per_iteration, int(iterations))
        return out.scaled_sum(self.per_replacement, int(replacements))

    def as_dict(self, iterations: int | None = None, replacements: int = 0) -> dict:
        out = {"setup": self.setup.as_dict(),
               "per_iteration": self.per_iteration.as_dict(),
               "per_replacement": self.per_replacement.as_dict()}
        if iterations is not None:
            out["totals"] = self.totals(iterations, replacements).as_dict()
            out["iterations"] = int(iterations)
            if replacements:
                out["replacements"] = int(replacements)
        return out


class _Collector:
    __slots__ = ("buckets", "tags", "first")

    def __init__(self):
        self.buckets: dict[str, CounterSnapshot] = {"setup": CounterSnapshot()}
        self.tags: list[str] = []
        self.first: dict[str, CounterSnapshot] = {}

    def bucket(self) -> CounterSnapshot:
        return self.bucket_of(self.tags[-1] if self.tags else "setup")

    def bucket_of(self, name: str) -> CounterSnapshot:
        return self.buckets.setdefault(name, CounterSnapshot())

    def stats(self) -> CommStats:
        return CommStats(
            setup=self.buckets.get("setup", CounterSnapshot()),
            per_iteration=self.first.get("iteration", CounterSnapshot()),
            per_replacement=self.first.get("replacement", CounterSnapshot()),
        )

    def total(self) -> CounterSnapshot:
        """Everything recorded, over every bucket: the live grand total."""
        out = CounterSnapshot()
        for b in self.buckets.values():
            out = out.scaled_sum(b, 1)
        return out


_STACK: list[_Collector] = []


def counting_enabled() -> bool:
    """True while a :func:`counting` collector is active."""
    return bool(_STACK)


@contextlib.contextmanager
def counting():
    """Collect comm counts from every instrumented call made inside."""
    col = _Collector()
    _STACK.append(col)
    try:
        yield col
    finally:
        _STACK.remove(col)


@contextlib.contextmanager
def tag(name: str):
    """Bucket tag (the solvers wrap their loop bodies in
    ``tag("iteration")``).  No-op when no collector is active.  Counts land
    in the INNERMOST collector only, so a solver counting itself never
    double-reports into an enclosing collector.  The first occurrence of
    a tag that is not nested in itself is kept apart as well (see the
    module docstring)."""
    if not _STACK:
        yield
        return
    col = _STACK[-1]
    first = name not in col.first and name not in col.tags
    col.tags.append(name)
    # Pop by position, not value: ``remove(name)`` strips the FIRST
    # occurrence, which under nested same-name tags would pop the outer
    # level and retag everything after the inner exit.
    depth = len(col.tags) - 1
    try:
        yield
    finally:
        del col.tags[depth]
        if first:
            # the tag's bucket was empty at its first entry: what it holds
            # now is that occurrence's counts
            col.first[name] = copy.deepcopy(col.bucket_of(name))


def halo_slab_bytes(shape, dim: int, width: int, itemsize: int) -> int:
    """Bytes one rank sends along ``dim``: the analytic halo volume
    ``2 (directions) * width * prod(face extents) * itemsize``."""
    face = math.prod(n for d, n in enumerate(shape) if d != dim)
    return 2 * int(width) * int(face) * int(itemsize)


def record_halo(shape, dim: int, width: int, itemsize: int):
    """Hook for :func:`repro_torch.core.halo.update_halo` (one array, one
    dim); ``shape`` is ONE block's shape, ``dim`` its axis."""
    if not _STACK:
        return
    _STACK[-1].bucket().add_halo(dim, halo_slab_bytes(shape, dim, width, itemsize))


def record_all_reduce(scalars: int = 1):
    """Hook for the global reductions (psum/pmax/pmin call sites)."""
    if not _STACK:
        return
    _STACK[-1].bucket().add_all_reduce(int(scalars))


def count_comm(fn, *args) -> CommStats:
    """Comm counts of one live call ``fn(*args)`` (the reference retraces
    abstractly; eager PyTorch runs the call).  Returns the ``setup`` /
    ``per_iteration`` / ``per_replacement`` split of :func:`tag`."""
    with counting() as col:
        fn(*args)
    return col.stats()
