"""The port's distributed-correctness analyzer (``repro_torch.analysis``).

Every case of the JAX package's ``tests/test_analysis.py``, ported with its
expected finding: the finding/baseline plumbing and the permutation
classifier, the staleness lattice on marker-level programs (a Python loop
takes the place of ``lax.while_loop``: the check runs its body), the
``hide_communication`` contract, the redundancy and ``stencil_read``
rules, the ``analyze_clean`` fixture on a solver capture, a capture that
runs no solver iteration, the zero-cost property on a Heat3D step (the
full pins are ``tests/test_torch_analysis_zero_cost.py``) and a clean
sweep subset.  Everything runs on the CPU; no check reaches a device.
"""

from __future__ import annotations

import json

import torch

from _torch_analysis import analyze_clean  # noqa: F401  (the fixture)
from repro_torch import analysis
from repro_torch.analysis import congruence, markers
from repro_torch.analysis.findings import Baseline, Finding, Report

# ---------------------------------------------------------------------------
# findings / report / baseline plumbing
# ---------------------------------------------------------------------------


def test_finding_fingerprint_stable_and_line_free():
    a = Finding("halo-staleness", "error", "solvers.cg", "stale read")
    b = Finding("halo-staleness", "error", "solvers.cg", "stale read")
    c = Finding("halo-staleness", "error", "solvers.cg", "other")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != c.fingerprint
    assert len(a.fingerprint) == 16


def test_report_dedup_and_views():
    f1 = Finding("r", "error", "s", "m")
    f2 = Finding("r", "error", "s", "m")  # same fingerprint
    f3 = Finding("r2", "perf", "s", "m")
    rep = Report([f1, f2, f3])
    assert len(rep) == 2
    assert [f.rule for f in rep.errors()] == ["r"]
    assert [f.rule for f in rep.by_rule("r2")] == ["r2"]
    assert "1 error" in rep.summary() and "1 perf" in rep.summary()


def test_baseline_roundtrip_and_gate(tmp_path):
    f1 = Finding("r", "error", "s", "m1")
    f2 = Finding("r", "error", "s", "m2")
    base = Baseline.from_report(Report([f1]), justification="known issue")
    p = tmp_path / "base.json"
    base.save(p)
    loaded = Baseline.load(p)
    assert loaded.suppresses(f1)
    assert not loaded.suppresses(f2)
    new = loaded.new_findings(Report([f1, f2]))
    assert [f.message for f in new] == ["m2"]
    assert loaded.unjustified() == []
    # the JAX package's format: version 1, one entry per fingerprint
    data = json.loads(p.read_text())
    assert data["version"] == 1 and set(data["findings"][0]) == {
        "fingerprint", "rule", "severity", "site", "message", "justification"}


# ---------------------------------------------------------------------------
# permutation table classifier
# ---------------------------------------------------------------------------

def test_classify_perm_tables():
    def ok(pairs, n):
        return congruence.classify_perm(pairs, n)[0]
    # complete ring (periodic wrap) and open shift (non-periodic)
    assert ok([(i, (i + 1) % 4) for i in range(4)], 4)
    assert ok([(0, 1), (1, 2), (2, 3)], 4)
    assert ok([(1, 0), (2, 1), (3, 2)], 4)  # reverse direction
    assert ok([], 1)  # single rank: nothing to send
    # broken tables
    assert not ok([], 4)                       # empty on a real axis
    assert not ok([(0, 1), (1, 2)], 4)         # partial open shift
    assert not ok([(0, 1), (0, 2)], 4)         # duplicate source
    assert not ok([(0, 1), (2, 1)], 4)         # duplicate destination
    assert not ok([(0, 5)], 4)                 # out of range
    assert ok([(0, 1), (1, 0), (2, 3), (3, 2)], 4)  # pairwise swap bijection


# ---------------------------------------------------------------------------
# staleness lattice on marker-level programs
# ---------------------------------------------------------------------------

def _check(fn, *args, halo=1):
    return analysis.check(fn, *args, halo=halo)


def test_staleness_clean_exchange_then_consume():
    def f(u):
        u = markers.exchange_out(u, width=1, site="t")
        return markers.consume(u, radius=1, site="t.op")

    assert not _check(f, torch.zeros(6, 6, 6))


def test_staleness_consume_deeper_than_entry():
    def f(u):
        return markers.consume(u, radius=2, site="t.op")

    rep = _check(f, torch.zeros(6, 6, 6), halo=1)
    assert rep.by_rule("halo-staleness") and rep.errors()


def test_staleness_decay_in_loop():
    # Consuming inside a loop with no exchange: fresh entry halos only
    # survive the first iteration.
    def f(u):
        for _ in range(10):
            u = markers.consume(u, radius=1, site="t.loop.op")
        return u

    rep = _check(f, torch.zeros(6, 6, 6))
    assert rep.by_rule("halo-staleness") and rep.errors()

    # ... and the exchange inside the loop fixes it.
    def g(u):
        for _ in range(10):
            u = markers.exchange_out(u, width=1, site="t.loop")
            u = markers.consume(u, radius=1, site="t.loop.op")
        return u

    assert not _check(g, torch.zeros(6, 6, 6))


def test_staleness_interior_write_propagates_staleness():
    # An interior write with a stale payload makes the RESULT stale too:
    # the neighbour's freshly written interior is exactly what my ghost
    # ring mirrors, so consuming without a new exchange is an error ...
    def f(u):
        u = markers.exchange_out(u.clone(), width=1, site="t")
        stale = markers.consume(u, radius=1, site="t.step") * 2.0
        u[1:-1] = stale[1:-1]
        return markers.consume(u, radius=1, site="t.op2")

    rep = _check(f, torch.zeros(6, 6, 6))
    assert rep.by_rule("halo-staleness") and rep.errors()

    # ... and re-exchanging after the write clears it.
    def g(u):
        u = markers.exchange_out(u.clone(), width=1, site="t")
        stale = markers.consume(u, radius=1, site="t.step") * 2.0
        u[1:-1] = stale[1:-1]
        u = markers.exchange_out(u, width=1, site="t.h2")
        return markers.consume(u, radius=1, site="t.op2")

    assert not _check(g, torch.zeros(6, 6, 6))


def test_hide_communication_contract_marker():
    # hide_communication's output carries its exchange contract: a step
    # built on it can be consumed again without a fresh update_halo.
    from repro_torch.core import init_global_grid
    from repro_torch.core.hide import hide_communication

    g = init_global_grid(8, 8, 8, dims=(1, 1, 1), periodic=(True, True, True), device="cpu")

    def step(u):
        return markers.consume(u, radius=1, site="t.step") * 0.5

    def f(u):
        out = hide_communication(g.topo, step, (u,), width=1)
        return markers.consume(out, radius=1, site="t.next")

    assert not _check(f, torch.zeros(g.shape))
    # without the hide (a plain step) the next read is stale
    assert _check(lambda u: markers.consume(step(u), radius=1, site="t.next"),
                  torch.zeros(g.shape)).errors()


def test_redundant_exchange_is_perf_finding():
    def f(u):
        u = markers.exchange_in(u, width=1, site="t.h1")
        u = markers.exchange_out(u, width=1, site="t.h1")
        u = markers.exchange_in(u, width=1, site="t.h2")
        u = markers.exchange_out(u, width=1, site="t.h2")
        return markers.consume(u, radius=1, site="t.op")

    rep = _check(f, torch.zeros(6, 6, 6))
    red = rep.by_rule("redundant-exchange")
    assert red and all(f.severity == "perf" for f in red)
    assert not rep.errors()


def test_public_stencil_read_marker():
    # User-facing hook: declare a deeper read than the remaining ghost
    # validity (a consume already spent one of the two fresh planes).
    def f(u):
        u = markers.consume(u, radius=1, site="t.op1")
        return analysis.stencil_read(u, radius=2, site="user.kernel")

    rep = _check(f, torch.zeros(6, 6, 6), halo=2)
    assert rep.by_rule("halo-staleness")


# ---------------------------------------------------------------------------
# the analyze_clean fixture on a real solver capture
# ---------------------------------------------------------------------------

def test_fixture_gates_a_solver_suite(analyze_clean):  # noqa: F811
    from repro_torch.apps import Poisson3D

    def run_solve():
        app = Poisson3D(nx=8, ny=8, nz=8, dims=(1, 1, 1), dtype=torch.float32, device="cpu")
        app.solve(method="cg")

    rep = analyze_clean(run_solve, capture=True)
    assert not rep.errors()


def test_capture_executes_no_solver_iterations(monkeypatch):
    # The capture records the solve on meta shadows and stops after the
    # loop's passes: no value is read, no kernel counted, nothing written.
    from repro_torch.analysis.capture import CaptureDone, capture
    from repro_torch.apps import Poisson3D
    from repro_torch.kernels.solver3d import kernel as sk

    app = Poisson3D(nx=8, ny=8, nz=8, dims=(1, 1, 1), dtype=torch.float32, device="cpu")
    before = {k: v.clone() for k, v in vars(app).items() if isinstance(v, torch.Tensor)}
    reads = []
    for name in ("__float__", "__bool__", "item"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name: reads.append(_n) or _o(self, *a))
    launches = [w.launches for w in sk.WRAPPERS]
    done = capture(lambda: app.solve(method="cg"))
    assert isinstance(done, CaptureDone)
    assert done.name == "cg" and done.halo == app.grid.halo
    assert reads == [] and done.trace._loops == {"solvers.cg": done.trace.passes}
    assert [w.launches for w in sk.WRAPPERS] == launches
    for k, v in before.items():
        assert torch.equal(getattr(app, k), v), k


# ---------------------------------------------------------------------------
# zero cost: a check leaves what the apps compute as it was
# ---------------------------------------------------------------------------

def test_step_identical_after_analysis():
    from repro_torch.analysis import driver
    from repro_torch.apps import Heat3D

    app = Heat3D(nx=16, ny=16, nz=16, hide=(8, 2, 2), dims=(2, 2, 2), device="cpu")
    T, Ci = app.init_fields()
    before = app._step(T.clone(), Ci).clone()
    rep = driver.heat_report(app)   # a full analysis pass over the same step
    assert not rep.errors(), [str(f) for f in rep]
    after = app._step(T.clone(), Ci)
    assert torch.equal(before, after)
    assert markers.TRACE is None


# ---------------------------------------------------------------------------
# real app targets (a subset; the whole matrix is tests/test_torch_analysis_sweep.py)
# ---------------------------------------------------------------------------

def test_sweep_subset_clean():
    from repro_torch.analysis.driver import merged, sweep

    reports = sweep(["poisson/cg[dirichlet]", "heat/step[hide]", "kernels/library"])
    assert len(reports) == 3, sorted(reports)
    total = merged(reports)
    assert not total.findings, [str(f) for f in total]
