"""Runtime solve-health watchdogs: typed status, probes, heartbeats.

The solvers of :mod:`repro_torch.solvers` read one host scalar per
iteration — the f64 residual norm of the stopping test.  This module
watches the solve on that same float:

* :class:`SolveStatus` — a typed outcome carried on every
  ``SolveInfo``/``PTInfo`` (always populated; classification is free);
* :func:`watch` — opt-in probes on the residual the loop already read:
  non-finite detection, divergence against the initial residual, a
  stagnation window, a sticky status and early exit.  They add no host
  read and no reduction per iteration; with no watch installed the loops
  run exactly as before;
* a rank-0 heartbeat every ``heartbeat_every`` iterations (from the
  process that holds block 0), and after the loop one final-health event
  per block this process holds with the last ``TAIL`` residuals, taken
  from the history the solver reads to the host once at the end anyway,
  emitted into the session (:mod:`.timers`) or straight into the flight
  recorder (:mod:`.flight`).  A watched solve does the
  same device work and the same host reads as an unwatched one.

Usage::

    from repro_torch import telemetry as tele

    with tele.watch(heartbeat_every=50, stagnation_window=100):
        x, info = app.solve("cg", tol=1e-8)
    info.status            # tele.SolveStatus.CONVERGED / DIVERGED_NONFINITE / ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math


class SolveStatus(enum.IntEnum):
    """Typed outcome of an iterative solve.

    ``RUNNING`` is the in-loop value; a finished solve always reports one
    of the terminal states.  ``failed`` distinguishes the pathological
    exits (the flight recorder auto-dumps on them) from the benign
    ``MAX_ITERATIONS``.
    """

    RUNNING = 0
    CONVERGED = 1
    MAX_ITERATIONS = 2
    DIVERGED_NONFINITE = 3
    STAGNATED = 4
    DIVERGED = 5

    @property
    def failed(self) -> bool:
        return self in (SolveStatus.DIVERGED_NONFINITE,
                        SolveStatus.STAGNATED, SolveStatus.DIVERGED)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Watchdog thresholds.

    ``stagnation_window`` — flag ``STAGNATED`` after this many consecutive
    iterations without a relative improvement of at least
    ``stagnation_rtol`` over the best residual so far (0 disables);
    ``divergence_factor`` — flag ``DIVERGED`` once the residual exceeds
    this multiple of the initial residual (0 disables);
    ``heartbeat_every`` — emit a rank-0 heartbeat event every k
    iterations (0 disables).  Non-finite detection and early exit are
    always on while a watch is installed.
    """

    stagnation_window: int = 0
    stagnation_rtol: float = 1e-3
    divergence_factor: float = 0.0
    heartbeat_every: int = 0


_CURRENT: HealthConfig | None = None

# residual-tail length carried into the per-rank final-health event
TAIL = 8


def current() -> HealthConfig | None:
    """The installed watchdog config, or None (no probes)."""
    return _CURRENT


def watching() -> bool:
    return _CURRENT is not None


@contextlib.contextmanager
def watch(*, stagnation_window: int = 0, stagnation_rtol: float = 1e-3,
          divergence_factor: float = 0.0, heartbeat_every: int = 0):
    """Install solve-health watchdogs for the duration of the block.

    Reentrant like :func:`repro_torch.telemetry.session`: an inner
    ``watch`` joins the active config (its own thresholds are ignored).
    """
    global _CURRENT
    if _CURRENT is not None:
        yield _CURRENT
        return
    cfg = HealthConfig(stagnation_window=stagnation_window,
                       stagnation_rtol=stagnation_rtol,
                       divergence_factor=divergence_factor,
                       heartbeat_every=heartbeat_every)
    _CURRENT = cfg
    try:
        yield cfg
    finally:
        _CURRENT = None


# ---------------------------------------------------------------------------
# the probe of one solve, on the host float the loop already read
# ---------------------------------------------------------------------------

class Probe:
    """Watchdog state of one solve (the reference's while-loop probe
    carry: status, best residual, iterations since the best).

    ``step(k, res)`` classifies the residual after iteration ``k`` and
    fires the heartbeat; it returns False once the (sticky) status left
    ``RUNNING``, which ends the loop.  ``res`` is the float the loop's
    stopping test read; ``bnorm`` the rhs norm as a float.  ``ranks`` are
    the global ranks of the blocks this process holds
    (``grid.topo.block_ranks()``): the heartbeat comes from the process
    holding block 0, and the final-health events name each of them.
    """

    def __init__(self, cfg: HealthConfig, solver: str, res0: float, bnorm: float, *,
                 ranks):
        self.cfg, self.solver = cfg, solver
        self.ranks = tuple(int(r) for r in ranks)
        self.res0, self.bnorm = res0, bnorm
        self.res = res0          # the last residual the loop read
        self.status = SolveStatus.RUNNING
        self.best, self.since = res0, 0

    def step(self, k: int, res: float) -> bool:
        cfg = self.cfg
        self.res = res
        finite = math.isfinite(res)
        improved = res < self.best * (1.0 - cfg.stagnation_rtol)
        self.since = 0 if improved else self.since + 1
        if finite:
            self.best = min(self.best, res)
        new = SolveStatus.RUNNING
        if cfg.divergence_factor > 0 and res > cfg.divergence_factor * self.res0:
            new = SolveStatus.DIVERGED
        if cfg.stagnation_window > 0 and self.since >= cfg.stagnation_window:
            new = SolveStatus.STAGNATED
        if not finite:
            new = SolveStatus.DIVERGED_NONFINITE
        if self.status == SolveStatus.RUNNING:
            self.status = new
        if cfg.heartbeat_every and k % cfg.heartbeat_every == 0 and 0 in self.ranks:
            _emit({"type": "heartbeat", "solver": self.solver, "rank": 0,
                   "iteration": int(k), "relres": res / self.bnorm}, rank=0)
        return self.status == SolveStatus.RUNNING

    def finalize(self, tol: float) -> SolveStatus:
        """Terminal status once the loop has exited, from the last residual
        it read.  A non-finite residual can predate the first probe (NaN in
        the very first residual exits the loop at k = 0: NaN comparisons
        are false), so finiteness is checked again here."""
        res = self.res
        if self.status != SolveStatus.RUNNING:
            return self.status
        if not math.isfinite(res):
            return SolveStatus.DIVERGED_NONFINITE
        return SolveStatus.CONVERGED if res <= tol * self.bnorm else SolveStatus.MAX_ITERATIONS

    def finish(self, k: int, relres: float, hist, tol: float, maxiter: int) -> SolveStatus:
        """:meth:`finalize`, then the final-health events: the solve's
        epilogue, on the relative residual and history it already read on
        the host (no device work here)."""
        status = self.finalize(tol)
        self.emit_final(k, relres, status, hist, maxiter)
        return status

    def emit_final(self, k: int, relres: float, status: SolveStatus, hist, maxiter: int):
        """One final-health event per block of :attr:`ranks` with the
        residual tail: the reference's window ``hist[start:start+n]`` of its
        zero-filled ``maxiter`` buffer, ``n = min(TAIL, maxiter)``.
        ``hist`` is the history already on the host."""
        n = min(TAIL, maxiter)
        start = min(max(k - n, 0), maxiter - n)
        tail = [float(hist[i]) if i < len(hist) else 0.0 for i in range(start, start + n)]
        for rank in self.ranks:
            _emit({"type": "health", "solver": self.solver, "rank": rank,
                   "iteration": int(k), "relres": float(relres),
                   "status": status.name, "residual_tail": list(tail)}, rank=rank)


def _emit(event: dict, rank=None):
    from .flight import record as _flight_record
    from .timers import current_session

    s = current_session()
    if s is not None:
        s.emit(dict(event))
    else:
        # no session: still land in the flight ring buffer directly
        _flight_record(event, rank=rank)


# ---------------------------------------------------------------------------
# host-side classification (works with or without a watch)
# ---------------------------------------------------------------------------

def classify(device_status: int | None, relres: float, tol: float,
             iterations: int, maxiter: int) -> SolveStatus:
    """Terminal :class:`SolveStatus` from the solve's scalars.

    Without probes the classification is still informative: a NaN residual
    exits the loop on its own (NaN comparisons are false), so non-finite
    divergence is detected even unwatched — the probes add
    stagnation/divergence detection, early exit and the per-rank events.
    """
    if device_status is not None:
        st = SolveStatus(int(device_status))
        if st != SolveStatus.RUNNING:
            return st
    if not math.isfinite(relres):
        return SolveStatus.DIVERGED_NONFINITE
    if relres <= tol:
        return SolveStatus.CONVERGED
    return SolveStatus.MAX_ITERATIONS


__all__ = ["HealthConfig", "Probe", "SolveStatus", "TAIL", "classify", "current", "watch",
           "watching"]
