"""Rule family 2: halo-staleness dataflow.

The reference's lattice (``repro.analysis.staleness``), evaluated as the
checked code runs (:class:`repro_torch.analysis.trace.Trace`).  Each
storage carries one integer: how many ghost planes of its halo ring are
FRESH (exchanged after the last write that could have invalidated them).
Transfer rules:

* inputs, and tensors made before the check, start at the grid halo width
  (the caller's contract: fields enter a solve halo-consistent);
* ``exchange_out`` (``update_halo``, and as a contract
  ``hide_communication``'s output) raises validity to the exchanged width;
* ``consume`` (the stencils) demands ``radius`` fresh planes — demand
  above validity is the staleness finding — and what the stencil computes
  has ``radius`` planes less;
* every other op gives its outputs the minimum over its tensor inputs; an
  in-place write (an interior slab, a ring) lowers the written storage to
  the minimum of its own and its inputs': the neighbour's freshly written
  interior is exactly what my ring mirrors, so the result is stale until
  the next exchange;
* a captured solver loop runs its body ``max(2, halo + 1)`` times: the
  reference's min-join fixpoint lowers a stale carry by at least one plane
  a pass, so a body that consumes ghosts without re-exchanging is caught
  by the pass after its validity reaches 0, although its first pass saw
  fresh inputs; a finding of a later pass replaces that of an earlier one
  at the same site.

Redundancy: an ``exchange_in`` on a storage whose last event was a
non-contract ``exchange_out`` of equal or wider coverage, with no write and
no stencil read in between, is a back-to-back double exchange — a pure
perf finding.  (The port exchanges in place: an operator's
``update_halo(u)`` refreshes the caller's ``u`` too, where the reference's
functional exchange leaves the caller's value as it was.  A stencil read
between two exchanges is that pattern, not a double exchange.)
"""

from __future__ import annotations

from .findings import Finding

RULE = "halo-staleness"
RULE_REDUNDANT = "redundant-exchange"


def consume(trace, valid: int, radius: int, site: str) -> None:
    if valid < radius:
        trace.add(Finding(
            RULE, "error", site,
            f"stencil reads {radius} ghost plane(s) but only {valid} are fresh — a halo "
            "exchange is missing on this path (wrong values on the inner shell)"))


def exchange_in(trace, st, width: int, site: str) -> None:
    last = st.last_exchange
    if last is None:
        return
    w, by, contract, writes = last
    if writes == st.writes and w >= width and not contract:
        trace.add(Finding(
            RULE_REDUNDANT, "perf", site,
            f"redundant back-to-back halo exchange: input already exchanged at width {w} "
            f"by {by} with no intervening stencil"))
