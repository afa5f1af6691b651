"""Solver telemetry — the observability layer of the port.

The paper's headline evidence is a *measured* number: the effective
memory throughput ``T_eff = A_eff / t_it`` and the communication a solve
does per iteration.  This package makes those numbers first-class:

* :mod:`timers`   — nestable region timers (synchronised on the card,
  per rank) emitting span events;
* :mod:`counters` — communication counters:
  :func:`repro_torch.core.halo.update_halo` and the all-reduce wrappers
  of :mod:`repro_torch.solvers.reductions` report into a collector, so a
  solve's halo bytes per rank and all-reduces per iteration are counted
  as it runs (one falsy check per call site when nothing collects);
* :mod:`health`   — typed solve status, watchdogs and heartbeats on the
  residual each loop already reads;
* :mod:`flight`   — a per-rank flight recorder dumping JSONL on failure,
  and :mod:`diag`, the host-only CLI that merges the dumps;
* :mod:`metrics`  — the paper's ``A_eff``/``T_eff`` convention;
* :mod:`sink`     — structured sinks: a no-op default, an in-memory
  recorder, JSONL metric events, and a Chrome-trace/Perfetto span export.

Everything is **off by default**: with no active session the hooks are a
single falsy check.  A benchmark enables it as::

    from repro_torch import telemetry as tele

    with tele.session(meta={"bench": "solvers"}) as s:
        with tele.region("solve", sync=lambda: u):
            u, info = app.solve("mgcg")
        s.metric("t_eff_gbs", tele.t_eff(a_eff_bytes, info.s_per_iter()))
    s.sink.dump_jsonl("metrics.jsonl")
    s.sink.dump_chrome_trace("trace.json")

While a session is active every solve's ``SolveInfo.comm`` carries a
:class:`CommStats` (setup / per iteration / per replacement), counted on
the live solve.
"""

import contextlib as _contextlib

from .counters import (
    CommStats, CounterSnapshot, counting, counting_enabled, count_comm,
    halo_slab_bytes, record_all_reduce, record_halo, tag,
)
from .flight import FlightRecorder, flight
from .health import HealthConfig, SolveStatus, watch, watching
from .metrics import a_eff, t_eff
from .sink import ChromeTraceSink, JsonlSink, MemorySink, NullSink
from .timers import (
    Session, current_session, enabled, metric, region, session,
)


@_contextlib.contextmanager
def observe(*, heartbeat: int = 0, flight_dir: str | None = None,
            flight_capacity: int = 256, meta: dict | None = None, **watch_kw):
    """One-stop runtime observability: flight recorder + health watch.

    ``heartbeat > 0`` installs solve-health watchdogs (:func:`watch`)
    with a rank-0 heartbeat every that many iterations; ``flight_dir``
    installs a per-rank flight recorder dumping there.  Both are
    reentrant, so app-level observe blocks compose under an outer
    session/watch.  With neither requested this is a no-op block.
    """
    with _contextlib.ExitStack() as stack:
        if flight_dir:
            stack.enter_context(flight(flight_dir, capacity=flight_capacity,
                                       meta=meta))
        if heartbeat or watch_kw:
            stack.enter_context(watch(heartbeat_every=heartbeat, **watch_kw))
        yield


__all__ = [
    "CommStats", "CounterSnapshot", "counting", "counting_enabled",
    "count_comm", "halo_slab_bytes", "record_all_reduce", "record_halo",
    "tag",
    "FlightRecorder", "flight",
    "HealthConfig", "SolveStatus", "watch", "watching",
    "a_eff", "t_eff",
    "ChromeTraceSink", "JsonlSink", "MemorySink", "NullSink",
    "Session", "current_session", "enabled", "metric", "region", "session",
    "observe",
]
