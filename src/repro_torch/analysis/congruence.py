"""Rule family 1: collective congruence.

A process group hangs when its processes do not issue the same
collectives in the same order, or when a point-to-point message has no
partner.  Two checks:

* **peer tables** — every halo exchange records, per grid dimension and
  direction, the table of (source block, destination block) pairs along
  that dimension that the exchange realises: the virtual-block roll
  inside a process plus :meth:`CartesianTopology.neighbour` between
  processes, evaluated for every process coordinate.  A table must be a
  complete bijection (periodic wrap) or a complete one-direction open
  shift (non-periodic: boundary blocks have no partner); duplicated
  sources or destinations, or holes, are the hang/corruption class
  (:func:`classify_perm`, the reference's classifier).  A receive table
  that differs from the send table is a message nobody sends.
* **cross-process sequences** — under a group, each process's recorded
  collective sequence (op, dtype, shape, reduction, peers) is compared
  with every other's through the group's key-value store, not through a
  collective, so a rank-dependent branch that skips a collective is a
  finding, never a hang.  Each process must publish within ``timeout``.

The reference's ``cond``-branch and ``while``-predicate checks read the
branches of a traced program; an eager process runs one branch, so their
counterpart is the cross-process comparison.
"""

from __future__ import annotations

import itertools
import pickle

from .findings import Finding

RULE = "collective-congruence"
GROUP_TIMEOUT = 30.0          # seconds a process waits for the others' sequences
_SEQ = itertools.count()      # checks of this process, in order (the same on every process)


def classify_perm(pairs, n: int) -> tuple[bool, str]:
    """Classify a permutation table over an axis of size ``n``.

    Returns ``(ok, reason)``.  OK tables: a complete bijection of
    ``range(n)`` (any permutation — wraps included), or a complete open
    shift (all pairs ``(i, i+s)`` with the same nonzero ``s``, covering
    every in-range source — the non-periodic neighbor exchange).
    """
    pairs = [(int(s), int(d)) for s, d in pairs]
    if not pairs:
        return (n <= 1), "empty table" if n > 1 else "empty (single rank)"
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs):
        return False, "duplicate source ranks (data races on send)"
    if len(set(dsts)) != len(dsts):
        return False, "duplicate destination ranks (lost messages)"
    oob = [p for p in pairs if not (0 <= p[0] < n and 0 <= p[1] < n)]
    if oob:
        return False, f"rank out of range for axis size {n}: {oob[0]}"
    if len(pairs) == n and set(srcs) == set(range(n)) \
            and set(dsts) == set(range(n)):
        return True, "complete bijection"
    shifts = {d - s for s, d in pairs}
    if len(shifts) == 1:
        s = shifts.pop()
        expected = {(i, i + s) for i in range(n) if 0 <= i + s < n}
        if set(pairs) == expected and s != 0:
            return True, "complete open shift"
    return False, (f"partial table covers {len(pairs)}/{n} ranks "
                   "(unpaired sends hang a blocking transport)")


def check_tables(tables) -> list[Finding]:
    findings = []
    for t in tables:
        site = f"{t['site']}/dim{t['gdim']}{'+' if t['shift'] > 0 else '-'}"
        ok, reason = classify_perm(t["send"], t["n"])
        if not ok:
            findings.append(Finding(
                RULE, "error", site,
                f"exchange table {sorted(t['send'])} on a dimension of {t['n']} blocks: "
                f"{reason}"))
        elif sorted(t["send"]) != sorted(t["recv"]):
            findings.append(Finding(
                RULE, "error", site,
                f"exchange tables disagree: blocks send {sorted(t['send'])} but receive "
                f"{sorted(t['recv'])} (a receive nobody sends hangs)"))
    return findings


def _signature(c: dict) -> tuple:
    return (c["op"], c["dtype"], c["shape"], c["reduce"])


def compare_sequences(seqs: list) -> list[Finding]:
    """Findings for the per-process collective sequences ``seqs`` (one
    list of recorded collectives per rank, None for a rank that did not
    publish)."""
    findings = []
    missing = [r for r, s in enumerate(seqs) if s is None]
    if missing:
        findings.append(Finding(
            RULE, "error", "group",
            f"rank(s) {missing} did not publish their collective sequence within "
            f"{GROUP_TIMEOUT:.0f} s — they left the check on another path"))
    ranks = [r for r, s in enumerate(seqs) if s is not None]
    if not ranks:
        return findings
    r0 = ranks[0]
    for r in ranks[1:]:
        a, b = seqs[r0], seqs[r]
        sa, sb = [_signature(c) for c in a], [_signature(c) for c in b]
        if sa == sb:
            continue
        i = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y), min(len(sa), len(sb)))
        at_a = f"{sa[i][0]} ({a[i]['site']})" if i < len(sa) else "nothing"
        at_b = f"{sb[i][0]} ({b[i]['site']})" if i < len(sb) else "nothing"
        findings.append(Finding(
            RULE, "error", "group",
            f"ranks issue different collective sequences: rank {r0} issues {len(sa)} "
            f"collective(s), rank {r} {len(sb)}; at position {i} rank {r0} issues {at_a} and "
            f"rank {r} {at_b} — a rank-dependent branch deadlocks"))
    # point-to-point partners: what a rank sends low, its low neighbour receives
    # high; what a rank shifts to its destination, the destination receives from it
    if not findings:
        for r in ranks:
            for i, c in enumerate(seqs[r]):
                if c["op"] == "shift":
                    src, dst = c["peers"]
                    for peer, side in ((dst, 0), (src, 1)):
                        if peer is None or seqs[peer] is None or seqs[peer][i]["peers"][side] == r:
                            continue
                        findings.append(Finding(
                            RULE, "error", "group",
                            f"shift at position {i}: rank {r} pairs with rank {peer}, which "
                            f"pairs with rank {seqs[peer][i]['peers'][side]} there "
                            "(an unpaired message hangs)"))
                    continue
                if c["op"] != "sendrecv":
                    continue
                low, high = c["peers"]
                for peer, side in ((low, 1), (high, 0)):
                    if peer is None or seqs[peer] is None:
                        continue
                    if seqs[peer][i]["peers"][side] != r:
                        findings.append(Finding(
                            RULE, "error", "group",
                            f"sendrecv at position {i}: rank {r} exchanges with rank {peer}, "
                            f"which expects rank {seqs[peer][i]['peers'][side]} there "
                            "(an unpaired message hangs)"))
    return findings


def compare_group(trace) -> list[Finding]:
    """Publish this process's sequence and compare it with every other
    process's (a no-op without a group of several processes)."""
    from ..core import comm
    if comm.world_size() <= 1:
        return []
    mine = [dict(c, tags=None) for c in trace.collectives]
    got = comm.exchange_through_store(f"repro_torch.analysis/{next(_SEQ)}",
                                      pickle.dumps(mine), GROUP_TIMEOUT)
    return compare_sequences([None if g is None else pickle.loads(g) for g in got])


def run(trace) -> list[Finding]:
    return check_tables(trace.tables) + compare_group(trace)
