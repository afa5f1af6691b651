"""Structured telemetry sinks.

Events are plain dicts with a ``type`` key:

* ``{"type": "span",   "name", "ts", "dur", "depth", "rank", ...}``
  — a timed region (seconds, relative to the session start);
* ``{"type": "metric", "name", "value", "rank", ...}``
  — a named scalar (e.g. ``t_eff_gbs``);
* ``{"type": "counter", "name", ...}`` — a counter snapshot.

``MemorySink`` (the session default) records events in order and can
serialize them two ways: one JSON object per line (:meth:`dump_jsonl`,
the machine-readable stream) and the
Chrome trace event format (:meth:`dump_chrome_trace`) loadable in
``ui.perfetto.dev`` / ``chrome://tracing`` — spans become complete
(``"ph": "X"``) events with one process row per rank, metrics become
instant events.
"""

from __future__ import annotations

import json


class NullSink:
    """The zero-cost default: drops every event."""

    def emit(self, event: dict):  # pragma: no cover - trivially empty
        pass


class MemorySink:
    """Record events in memory; serialize on demand."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict):
        self.events.append(event)

    # -- serializers ---------------------------------------------------
    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    def chrome_trace_events(self) -> list[dict]:
        out = []
        for ev in self.events:
            rank = ev.get("rank", 0)
            if ev.get("type") == "span":
                out.append({
                    "name": ev["name"], "ph": "X", "cat": "region",
                    "ts": ev["ts"] * 1e6, "dur": ev["dur"] * 1e6,
                    "pid": rank, "tid": 0,
                    "args": {k: v for k, v in ev.items()
                             if k not in ("type", "name", "ts", "dur",
                                          "rank", "depth")},
                })
            elif ev.get("type") == "metric":
                out.append({
                    "name": ev["name"], "ph": "i", "cat": "metric",
                    "ts": ev.get("ts", 0.0) * 1e6, "pid": rank, "tid": 0,
                    "s": "p",
                    "args": {"value": ev.get("value")},
                })
        return out

    def dump_chrome_trace(self, path: str):
        trace = {"traceEvents": self.chrome_trace_events(),
                 "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(trace, f)


class JsonlSink:
    """Stream every event to ``path`` as it is emitted (one JSON/line)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def emit(self, event: dict):
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class ChromeTraceSink(MemorySink):
    """A MemorySink that writes the Chrome trace to ``path`` on close."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def close(self):
        self.dump_chrome_trace(self.path)
