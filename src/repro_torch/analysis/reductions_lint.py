"""Rule family 4: reduction exactness.

The blocks of a field duplicate overlap cells, so a bare ``torch.sum``
over a field followed by an all-reduce over-counts them — global
reductions must route through :mod:`repro_torch.solvers.reductions`,
whose wrappers (a) tag the all-reduce operand as blessed and (b) multiply
in an ownership mask before the local reduction.  The port's single
caller of ``torch.distributed`` is :mod:`repro_torch.core.comm`; every
``comm.all_reduce`` a check records is checked when its operand's
provenance holds a full-field local reduction (a sum, max, min, ... over
a tensor of rank >= 2 — scalar bookkeeping reductions are exempt):

* **bare collective** — the operand was not entered through
  ``psum``/``pmax``/``pmin`` (error);
* **unmasked reduction** — no ownership evidence in its provenance:
  overlap cells are double-counted (error).  Evidence is a ``mask``
  marker (``owned_mask``/``interior_mask``), or a field of rank >= 2 made
  before the check and not an input (the reference's constant terminal: a
  mask an app built once and keeps);
* **f32 accumulator** — a sum over a float32 field: the masked helpers
  accumulate in float64 (``reductions.acc_dtype``) so f32 solves keep
  f64 stopping tests (warning).  The port has no x64 switch; float64
  accumulators are always available.
"""

from __future__ import annotations

from .findings import Finding

RULE = "reduction-exactness"
_NAMES = {"sum": "psum", "max": "pmax", "min": "pmin"}


def run(trace) -> list[Finding]:
    findings = []
    for c in trace.collectives:
        if c["op"] != "all_reduce":
            continue
        tags = c["tags"]
        big = sorted(t[4:] for t in tags if t.startswith("big:"))
        if not big:
            continue  # scalar bookkeeping reduction — exempt
        prim = _NAMES.get(c["reduce"], c["reduce"])
        site = c["site"]
        if "reduce" not in tags:
            findings.append(Finding(
                RULE, "error", site,
                f"bare {prim} over a full-field reduction bypasses "
                "repro_torch.solvers.reductions — overlap cells are double-counted and "
                "telemetry misses the collective"))
        if "mask" not in tags and "const" not in tags:
            findings.append(Finding(
                RULE, "error", site,
                f"{prim} over an unmasked field reduction: overlap cells of the blocks enter "
                "the global sum twice — multiply by reductions.owned_mask (or solve_mask) "
                "before reducing"))
        if c["reduce"] == "sum" and "torch.float32" in big:
            findings.append(Finding(
                RULE, "warning", site,
                "float32 accumulator in a global sum — route through reductions.acc_dtype so "
                "f32 solves keep f64 stopping tests"))
    return findings
