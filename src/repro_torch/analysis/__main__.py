"""CLI: sweep the app matrix and gate on a baseline.

    python -m repro_torch.analysis [--device cpu|cuda] [--targets poisson heat ...]
                                   [--report out.json]
                                   [--baseline analysis-baseline.json]
                                   [--write-baseline]

Exit status: 0 when every finding is suppressed by the baseline (or the
tree is clean), 1 when new findings appear, 2 on usage errors.  The
baseline is the JAX package's format (``repro.analysis.findings``).
``--device cuda`` builds the apps on the card (nothing is launched: a
check records launch plans); off the card the ``cuda`` targets build their
apps on the meta device.  The ``group/`` targets start two gloo processes
of their own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="distributed-correctness analyzer of the port")
    ap.add_argument("--device", default="cpu",
                    help="device the apps are built on (cpu or cuda; default cpu)")
    ap.add_argument("--targets", nargs="*", default=None,
                    help="substring filters on target names (default: all)")
    ap.add_argument("--report", default=None,
                    help="write the full findings report (JSON) here")
    ap.add_argument("--baseline", default=None,
                    help="baseline/suppression file to gate against")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline (requires --baseline)")
    args = ap.parse_args(argv)
    if args.write_baseline and not args.baseline:
        ap.error("--write-baseline requires --baseline")

    from .driver import merged, sweep
    from .findings import Baseline, Report

    reports = sweep(args.targets, device=args.device)
    total = merged(reports)
    for name in sorted(reports):
        rep = reports[name]
        print(f"{name}: {rep.summary()}")
        for f in rep:
            print(f"  {f}")
    print(f"TOTAL: {total.summary()} over {len(reports)} target(s)")

    if args.report:
        out = total.as_dict()
        out["targets"] = {name: reports[name].as_dict() for name in sorted(reports)}
        with open(args.report, "w") as fh:
            json.dump(out, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"report written to {args.report}")

    if args.write_baseline:
        Baseline.from_report(total, justification="accepted at baseline creation").save(
            args.baseline)
        print(f"baseline written to {args.baseline} ({len(total)} suppression(s))")
        return 0

    if args.baseline and os.path.exists(args.baseline):
        base = Baseline.load(args.baseline)
        for e in base.unjustified():
            print(f"note: baseline entry {e['fingerprint']} ({e['rule']} @ {e['site']}) "
                  "has no justification")
        new = base.new_findings(total)
    else:
        new = total.findings

    if new:
        print(f"FAIL: {len(new)} new finding(s) not in baseline:")
        for f in Report(new):
            print(f"  {f}")
        return 1
    print("PASS: no new findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
