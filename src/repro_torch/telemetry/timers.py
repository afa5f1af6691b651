"""Region timers and the telemetry session.

A :class:`Session` owns a sink and a monotonic clock origin; it is
installed module-wide by the :func:`session` context manager (or
``Session.start()``).  With no session installed, :func:`region` and
:func:`metric` cost one falsy check.

Regions are nestable and **synced**: CUDA launches are asynchronous, so a
bare ``perf_counter`` pair around a call times the launches, not the
work.  ``region(name, sync=...)`` waits at the region's exit until the
value (or the result of the callable) is ready — a
``torch.cuda.synchronize`` on each CUDA device it lives on, nothing for
CPU tensors — before closing the span.  Spans are host time.  ``rank``
is the process's rank (:func:`process_rank`), so multi-process traces
merge into one Perfetto timeline with a row per rank.
"""

from __future__ import annotations

import contextlib
import time

from .sink import MemorySink, NullSink


def process_rank() -> int:
    """This process's rank in the default process group, else 0."""
    from ..core import comm

    return comm.rank()


class Session:
    """An active telemetry session: clock origin + sink + span stack."""

    def __init__(self, sink=None, meta: dict | None = None):
        self.sink = MemorySink() if sink is None else sink
        self.meta = dict(meta or {})
        self.t0 = time.perf_counter()
        self._depth = 0
        self.rank = process_rank()

    # -- event emission ------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self.t0

    def emit(self, event: dict):
        self.sink.emit(event)
        # mirror into the flight recorder's per-rank ring buffer (a single
        # None check when no recorder is installed)
        from .flight import current as _flight_current
        rec = _flight_current()
        if rec is not None:
            rec.record(event)

    def span(self, name: str, ts: float, dur: float, **attrs):
        self.emit({"type": "span", "name": name, "ts": ts, "dur": dur,
                   "depth": self._depth, "rank": self.rank, **attrs})

    def metric(self, name: str, value, **attrs):
        self.emit({"type": "metric", "name": name, "value": value,
                   "ts": self.now(), "rank": self.rank, **attrs})

    def counter(self, name: str, snapshot: dict, **attrs):
        self.emit({"type": "counter", "name": name, "rank": self.rank,
                   **snapshot, **attrs})

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Session":
        global _CURRENT
        if _CURRENT is not None:
            raise RuntimeError("a telemetry session is already active")
        _CURRENT = self
        return self

    def stop(self):
        global _CURRENT
        if _CURRENT is self:
            _CURRENT = None


_CURRENT: Session | None = None


def current_session() -> Session | None:
    return _CURRENT


def enabled() -> bool:
    return _CURRENT is not None


@contextlib.contextmanager
def session(sink=None, meta: dict | None = None):
    """Install a telemetry session for the duration of the block.

    Reentrant: if a session is already active, the block joins it (the
    inner ``sink``/``meta`` are ignored).  Use ``Session(...).start()`` to
    insist on exclusivity.
    """
    if _CURRENT is not None:
        yield _CURRENT
        return
    s = Session(sink=sink, meta=meta).start()
    try:
        yield s
    finally:
        s.stop()


def _devices(value) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, a Field or
    FieldSet, or a tuple/list/dict of them)."""
    import torch

    out, todo = set(), [value]
    while todo:
        v = todo.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                out.add(v.device)
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, (tuple, list)):
            todo.extend(v)
        elif hasattr(v, "items"):            # a FieldSet
            todo.extend(x for _, x in v.items())
        elif hasattr(v, "data"):             # a Field
            todo.append(v.data)
    return out


def _sync(value):
    import torch

    for dev in _devices(value() if callable(value) else value):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def region(name: str, *, sync=None, **attrs):
    """Time a region; emits a span event to the active session.

    ``sync`` — a tensor/tree (or a zero-arg callable returning one) waited
    for before the span closes, so asynchronously launched device work is
    charged to the region that launched it.  No-op (single falsy check, no
    sync) when no session is active.
    """
    s = _CURRENT
    if s is None:
        yield
        return
    s._depth += 1
    t0 = s.now()
    try:
        yield
        if sync is not None:
            _sync(sync)
    finally:
        s._depth -= 1
        t1 = s.now()
        s.span(name, t0, t1 - t0, **attrs)


def metric(name: str, value, **attrs):
    """Emit a metric event to the active session (no-op when disabled)."""
    if _CURRENT is not None:
        _CURRENT.metric(name, value, **attrs)


__all__ = ["Session", "current_session", "enabled", "metric", "process_rank", "region",
           "session", "MemorySink", "NullSink"]
