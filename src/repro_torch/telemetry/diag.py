"""Cross-rank flight-record diagnosis: merge + load-imbalance report.

``python -m repro_torch.telemetry.diag RUNDIR [--out trace.json]`` reads the
per-rank ``flight-rank*.jsonl`` files a
:class:`~repro_torch.telemetry.flight.FlightRecorder` dumped, merges them into
ONE clock-aligned Chrome-trace/Perfetto file (one process row per rank —
load it at ``ui.perfetto.dev``), and prints a load-imbalance report: for
every timed region, the per-rank total durations' max/min/mean across
ranks and the imbalance ratio max/mean.  That turns the
"is rank 1731 the straggler?" question into a one-command post-mortem —
no rerun, no per-rank grepping.

Clock alignment: every flight file's header carries the recorder's epoch
(``time.time()`` at installation) and every event a ``wall`` stamp taken
when it was recorded; merged timestamps are wall-clock microseconds
relative to the earliest header across files, so records dumped by
different host processes line up on one timeline.

Pure host-side module — no torch import, safe on a login node (the
port's own copy of the reference's CLI).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def find_flight_files(paths: list[str]) -> list[str]:
    """Expand directories to their flight-rank*.jsonl files."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "flight-rank*.jsonl"))))
        else:
            out.append(p)
    return sorted(set(out))


def load_records(files: list[str]) -> list[dict]:
    """Parse flight files into ``{"path", "header", "events"}`` records."""
    records = []
    for path in files:
        header, events = None, []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if ev.get("type") == "flight_header":
                    header = ev
                else:
                    events.append(ev)
        if header is None:
            header = {"type": "flight_header", "rank": len(records),
                      "epoch": min((e.get("wall", 0.0) for e in events),
                                   default=0.0), "reason": "unknown"}
        records.append({"path": path, "header": header, "events": events})
    return records


def merge_chrome_trace(records: list[dict]) -> dict:
    """One clock-aligned Chrome-trace dict from per-rank flight records."""
    t0 = min((r["header"].get("epoch", 0.0) for r in records), default=0.0)
    trace_events = []
    for r in records:
        rank = int(r["header"].get("rank", 0))
        trace_events.append({"ph": "M", "name": "process_name", "pid": rank,
                             "tid": 0, "args": {"name": f"rank {rank}"}})
        for ev in r["events"]:
            pid = int(ev.get("rank", rank))
            wall = float(ev.get("wall", r["header"].get("epoch", t0)))
            kind = ev.get("type")
            if kind == "span":
                dur = float(ev.get("dur", 0.0))
                # spans are recorded at close; start = wall - dur
                trace_events.append({
                    "name": ev.get("name", "span"), "ph": "X",
                    "cat": "region", "ts": (wall - dur - t0) * 1e6,
                    "dur": dur * 1e6, "pid": pid, "tid": 0,
                    "args": {k: v for k, v in ev.items()
                             if k not in ("type", "name", "ts", "dur",
                                          "rank", "depth", "wall")},
                })
            else:
                name = ev.get("name") or ev.get("solver") or kind or "event"
                trace_events.append({
                    "name": f"{kind}:{name}" if kind else str(name),
                    "ph": "i", "cat": kind or "event", "s": "p",
                    "ts": (wall - t0) * 1e6, "pid": pid, "tid": 0,
                    "args": {k: v for k, v in ev.items()
                             if k not in ("type", "rank", "wall")},
                })
    trace_events.sort(key=lambda e: (e["ph"] == "M", e.get("ts", 0.0)))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def imbalance(records: list[dict]) -> list[dict]:
    """Per-region load-imbalance rows across ranks.

    Each row: region name, number of ranks that timed it, per-rank TOTAL
    seconds (max/min/mean) and ``imbalance = max/mean`` — the straggler
    factor (1.0 = perfectly balanced).
    """
    per_region: dict[str, dict[int, float]] = {}
    for r in records:
        rank = int(r["header"].get("rank", 0))
        for ev in r["events"]:
            if ev.get("type") != "span":
                continue
            name = ev.get("name", "span")
            pid = int(ev.get("rank", rank))
            per_region.setdefault(name, {})
            per_region[name][pid] = per_region[name].get(pid, 0.0) \
                + float(ev.get("dur", 0.0))
    rows = []
    for name in sorted(per_region):
        totals = per_region[name]
        vals = list(totals.values())
        mean = sum(vals) / len(vals)
        rows.append({"region": name, "n_ranks": len(vals),
                     "max_s": max(vals), "min_s": min(vals), "mean_s": mean,
                     "imbalance": (max(vals) / mean) if mean > 0 else 1.0,
                     "max_rank": max(totals, key=totals.get)})
    rows.sort(key=lambda r: r["max_s"], reverse=True)
    return rows


def render_report(records: list[dict], rows: list[dict]) -> str:
    lines = ["== flight-record diagnosis =="]
    for r in records:
        h = r["header"]
        lines.append(
            f"  rank {h.get('rank', '?'):>4}: {len(r['events'])} events, "
            f"dumped on {h.get('reason', '?')} "
            f"({os.path.basename(r['path'])})")
        last_health = [e for e in r["events"] if e.get("type") == "health"]
        if last_health:
            e = last_health[-1]
            lines.append(f"    last health: {e.get('status')} "
                         f"@ iteration {e.get('iteration')} "
                         f"(relres {e.get('relres'):.3e})")
    if rows:
        lines.append("  -- per-region load imbalance (seconds/rank) --")
        lines.append(f"  {'region':32s} {'ranks':>5s} {'max':>9s} "
                     f"{'min':>9s} {'mean':>9s} {'max/mean':>8s} {'worst':>5s}")
        for row in rows:
            lines.append(
                f"  {row['region']:32s} {row['n_ranks']:5d} "
                f"{row['max_s']:9.4f} {row['min_s']:9.4f} "
                f"{row['mean_s']:9.4f} {row['imbalance']:8.2f} "
                f"{row['max_rank']:5d}")
    else:
        lines.append("  (no span events — enable a session or region timers)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.diag",
        description="Merge per-rank flight records into one Perfetto trace "
                    "and print a cross-rank load-imbalance report.")
    ap.add_argument("paths", nargs="+",
                    help="flight-record dump dir(s) or flight-rank*.jsonl "
                         "file(s)")
    ap.add_argument("--out", metavar="TRACE.json",
                    help="write the merged Chrome/Perfetto trace here")
    args = ap.parse_args(argv)

    files = find_flight_files(args.paths)
    if not files:
        print(f"no flight-rank*.jsonl records under {args.paths}",
              file=sys.stderr)
        return 1
    records = load_records(files)
    rows = imbalance(records)
    print(render_report(records, rows))
    if args.out:
        trace = merge_chrome_trace(records)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"  merged trace -> {args.out} "
              f"({len(trace['traceEvents'])} events; open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
