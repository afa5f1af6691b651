"""Per-rank flight recorder: a bounded ring buffer with post-mortem dumps.

A large campaign is debuggable only if the rank that failed left evidence
behind without anyone asking for it in advance.  The flight recorder
keeps the last ``capacity`` structured events PER RANK (region timings,
comm stats, solve summaries with residual tails, heartbeat /
final-health events from :mod:`repro_torch.telemetry.health`, memory
watermarks) in bounded host memory, and dumps them as one JSONL file per
rank — ``flight-rank0000.jsonl`` … — when something goes wrong:

* an exception escapes the ``flight(...)`` context,
* the process receives ``SIGTERM``/``SIGUSR1`` (job-scheduler preemption),
* a solve finishes with a failed :class:`~.health.SolveStatus`
  (``DIVERGED_NONFINITE`` / ``STAGNATED`` / ``DIVERGED``).

Each file starts with a ``flight_header`` line carrying the recorder's
epoch (wall-clock origin) so ``python -m repro_torch.telemetry.diag`` can
merge records from many hosts into one clock-aligned Perfetto trace.

The recorder composes with the session stack: while a flight context is
active every session event (spans, metrics, counters) is mirrored into
the ring buffer, and if no session is active the context opens a private
null-sink session so region timers still flow in.  Installation is a
context manager::

    with tele.flight("out/flight", meta={"app": "twophase"}):
        app.run(nt)

Every block's buffer lives in the process that holds the block: the
per-block health events route by their block's rank, host-side events
carry the process rank (:func:`repro_torch.telemetry.timers.process_rank`).
So each process dumps its own blocks' files, and the files of a run spread
over processes are the files of the same run in one process; the diag CLI
merges them either way.  A process that holds several blocks may not hold
the block its rank names, whose file another process writes: its
host-side events then go into the file of the first block it has events
of (:meth:`FlightRecorder.dump`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import signal
import time

from .sink import NullSink
from .timers import process_rank

_CURRENT: "FlightRecorder | None" = None

# Event types that are about one block and carry that block's rank.
_BLOCK_EVENTS = ("health", "heartbeat")

_DUMP_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


def current() -> "FlightRecorder | None":
    return _CURRENT


def record(event: dict, rank: int | None = None):
    """Append an event to the active flight recorder (no-op without one)."""
    if _CURRENT is not None:
        _CURRENT.record(event, rank=rank)


def memory_watermark() -> dict:
    """Device + host memory high-water marks, best effort.

    The host RSS peak (``ru_maxrss``) is always included as a floor; on a
    CUDA card that PyTorch has initialised, each device's allocated and
    peak-allocated bytes (``torch.cuda.memory_allocated`` /
    ``max_memory_allocated``) come beside it.
    """
    out: dict = {}
    try:
        import resource
        out["host_peak_rss_kb"] = int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:
        pass
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            out["devices"] = {
                i: {"bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i))}
                for i in range(torch.cuda.device_count())}
    except Exception:
        pass
    return out


class FlightRecorder:
    """Bounded per-rank event buffers + JSONL dumps."""

    def __init__(self, dir: str = ".", capacity: int = 256,
                 meta: dict | None = None):
        self.dir = dir
        self.capacity = int(capacity)
        self.meta = dict(meta or {})
        self.epoch = time.time()
        self.host_rank = process_rank()
        self._buffers: dict[int, collections.deque] = {}
        self._blocks: set[int] = set()   # ranks of the per-block events
        self.dump_count = 0
        self.dumped_paths: list[str] = []

    def record(self, event: dict, rank: int | None = None):
        # route by the event's own rank (final-health events stamp it) so
        # session-mirrored per-rank events land in the right ring buffer
        if rank is None:
            rank = event.get("rank")
        r = self.host_rank if rank is None else int(rank)
        if event.get("type") in _BLOCK_EVENTS:
            self._blocks.add(r)
        ev = dict(event)
        ev.setdefault("wall", time.time())
        buf = self._buffers.get(r)
        if buf is None:
            buf = self._buffers[r] = collections.deque(maxlen=self.capacity)
        buf.append(ev)

    @property
    def ranks(self) -> list[int]:
        return sorted(self._buffers)

    def events(self, rank: int | None = None) -> list[dict]:
        r = self.host_rank if rank is None else int(rank)
        return list(self._buffers.get(r, ()))

    def _files(self) -> dict[int, list[dict]]:
        """The events of each file, by rank: the buffers, with the
        host-side events moved into the first block's file when this
        process has per-block events but none of the block its rank names
        (under a process group that block is another process's)."""
        files = {r: list(b) for r, b in self._buffers.items()}
        if self._blocks and self.host_rank not in self._blocks and self.host_rank in files:
            first = min(self._blocks)
            files[first] = sorted(files.pop(self.host_rank) + files[first],
                                  key=lambda e: e["wall"])
        return files or {self.host_rank: []}

    def dump(self, reason: str = "manual") -> list[str]:
        """Write one ``flight-rank<r>.jsonl`` per buffered rank."""
        os.makedirs(self.dir, exist_ok=True)
        mem = memory_watermark()
        paths = []
        for r, buf in sorted(self._files().items()):
            path = os.path.join(self.dir, f"flight-rank{r:04d}.jsonl")
            header = {"type": "flight_header", "rank": r,
                      "host_rank": self.host_rank, "epoch": self.epoch,
                      "wall": time.time(), "reason": reason,
                      "capacity": self.capacity, "n_events": len(buf),
                      "memory": mem, "meta": self.meta}
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for ev in buf:
                    f.write(json.dumps(ev, default=str) + "\n")
            paths.append(path)
        self.dump_count += 1
        self.dumped_paths = paths
        return paths


def note_solve(solver: str, info):
    """Record a solve summary; auto-dump when the status is a failure.

    Solvers call this after every solve — a single None check when no
    recorder is installed.
    """
    rec = _CURRENT
    if rec is None:
        return
    status = getattr(info, "status", None)
    ev = {"type": "solve", "solver": solver,
          "iterations": info.iterations, "relres": float(info.relres),
          "converged": bool(info.converged), "wall_s": info.wall_s,
          "status": status.name if status is not None else None,
          "residual_tail": [float(v) for v in info.residuals[-8:]]}
    if info.comm is not None:
        ev["comm"] = info.comm.as_dict(iterations=info.iterations)
    rec.record(ev)
    if status is not None and status.failed:
        rec.dump(reason=f"status:{status.name}")


@contextlib.contextmanager
def flight(dir: str = ".", capacity: int = 256, meta: dict | None = None,
           dump_on_exit: bool = False, signals: bool = True):
    """Install a flight recorder for the duration of the block.

    Reentrant: an inner ``flight`` joins the active recorder (its own
    dir/capacity are ignored).  ``dump_on_exit`` forces a dump on clean
    exit too (useful for the diag CLI on healthy runs); ``signals``
    installs SIGTERM/SIGUSR1 dump handlers (main thread only; chained to
    any previous handler).
    """
    global _CURRENT
    if _CURRENT is not None:
        yield _CURRENT
        return
    rec = FlightRecorder(dir=dir, capacity=capacity, meta=meta)
    _CURRENT = rec

    from . import timers
    own_session = None
    if timers.current_session() is None:
        # private null-sink session so region timers/metrics still emit
        # (Session.emit mirrors every event into this recorder)
        own_session = timers.Session(sink=NullSink()).start()

    prev_handlers = {}
    if signals:
        def _handler(signum, frame):
            rec.record({"type": "signal", "signum": int(signum)})
            rec.dump(reason=f"signal:{signum}")
            prev = prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)

        for sig in _DUMP_SIGNALS:
            try:
                prev_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                break
    try:
        yield rec
    except BaseException as e:
        rec.record({"type": "exception", "error": repr(e)})
        rec.dump(reason=f"exception:{type(e).__name__}")
        raise
    finally:
        for sig, prev in prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        if own_session is not None:
            own_session.stop()
        if dump_on_exit and rec.dump_count == 0:
            rec.dump(reason="exit")
        _CURRENT = None


__all__ = ["FlightRecorder", "current", "flight", "memory_watermark",
           "note_solve", "record"]
