"""Typed findings, reports, and the baseline/suppression file format.

A :class:`Finding` is one rule violation (or perf observation) anchored
to a ``site`` — a dotted instrumentation-site name (e.g.
``core.halo.update_halo``) optionally extended with the solver a capture
recorded (``cg/...``).  Findings are
content-addressed: the ``fingerprint`` hashes ``rule | site | message``
so a baseline file can suppress *known* findings without pinning line
numbers, and CI can gate on "no new findings".  The format is the JAX
package's (``repro.analysis.findings``), so a baseline reads in either.

Baseline/suppression format (``results/analysis-baseline.json``)::

    {
      "version": 1,
      "findings": [
        {"fingerprint": "...", "rule": "...", "site": "...",
         "message": "...", "justification": "why this is acceptable"}
      ]
    }

Every suppressed finding carries a human ``justification`` — a baseline
entry without one is treated as suppressed but flagged by the CLI so
reviews see it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Iterator

SEVERITIES = ("error", "warning", "perf", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result: ``rule`` family, ``severity``, the ``site``
    it anchors to, and a human-readable ``message``."""

    rule: str
    severity: str
    site: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; pick from {SEVERITIES}")

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.rule}|{self.site}|{self.message}".encode()).hexdigest()
        return h[:16]

    def as_dict(self) -> dict:
        return {"fingerprint": self.fingerprint, "rule": self.rule,
                "severity": self.severity, "site": self.site,
                "message": self.message}

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.message}"


class Report:
    """A deduplicated, ordered collection of findings.

    Rules may rediscover the same finding (a capture runs a loop body
    several times); the report keeps the first occurrence of each
    fingerprint.
    """

    def __init__(self, findings: Iterable[Finding] = ()):
        self._by_fp: dict[str, Finding] = {}
        self.extend(findings)

    # -- collection -----------------------------------------------------
    def add(self, finding: Finding) -> None:
        self._by_fp.setdefault(finding.fingerprint, finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        for f in findings:
            self.add(f)

    def merge(self, other: "Report") -> None:
        self.extend(other.findings)

    # -- views ----------------------------------------------------------
    @property
    def findings(self) -> list[Finding]:
        return list(self._by_fp.values())

    def __len__(self) -> int:
        return len(self._by_fp)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self._by_fp.values())

    def __bool__(self) -> bool:
        return bool(self._by_fp)

    def by_severity(self, *severities: str) -> list[Finding]:
        return [f for f in self if f.severity in severities]

    def errors(self) -> list[Finding]:
        return self.by_severity("error")

    def by_rule(self, rule: str) -> list[Finding]:
        return [f for f in self if f.rule == rule]

    def summary(self) -> str:
        if not self:
            return "clean (no findings)"
        counts: dict[str, int] = {}
        for f in self:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        parts = [f"{counts[s]} {s}" for s in SEVERITIES if s in counts]
        return f"{len(self)} finding(s): " + ", ".join(parts)

    # -- serialization --------------------------------------------------
    def as_dict(self) -> dict:
        return {"version": 1,
                "findings": [f.as_dict() for f in self.findings]}

    def to_json(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")


@dataclasses.dataclass
class Baseline:
    """Suppression list: fingerprints of accepted findings."""

    entries: dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path) as fh:
            data = json.load(fh)
        return cls(entries={e["fingerprint"]: e
                            for e in data.get("findings", [])})

    @classmethod
    def from_report(cls, report: Report,
                    justification: str = "") -> "Baseline":
        entries = {}
        for f in report.findings:
            e = f.as_dict()
            e["justification"] = justification
            entries[f.fingerprint] = e
        return cls(entries=entries)

    def save(self, path) -> None:
        data = {"version": 1,
                "findings": sorted(self.entries.values(),
                                   key=lambda e: e["fingerprint"])}
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def suppresses(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def unjustified(self) -> list[dict]:
        return [e for e in self.entries.values()
                if not e.get("justification")]

    def new_findings(self, report: Report) -> list[Finding]:
        """Findings in ``report`` not covered by this baseline — the CI
        gate fails when this is non-empty."""
        return [f for f in report.findings if not self.suppresses(f)]
