"""The port's telemetry (``repro_torch.telemetry``) against the JAX package's.

* The units of ``tests/test_telemetry.py`` (halo-volume formula, counter
  arithmetic, tag nesting, sinks and their serialisations, the flight
  recorder's composition with sessions, ``observe``), on the port's copies.
* Communication counts (``SolveInfo.comm``) of ``Poisson3D(nx=10, ny=10,
  nz=10, dims=(2, 2, 2))`` solves against the reference's, integer for
  integer: one ``update_halo`` of center, face and width-2 fields; cg,
  pipecg, pt, and mg and mgcg with one Jacobi sweep per smoother call
  (``nu_pre = nu_post = coarse_sweeps = 1``), every snapshot EQUAL.  The
  reference counts one trace of its compiled solve, so a ``fori_loop`` of
  Jacobi sweeps counts as one sweep; the port counts every sweep it makes.
  For the default mg (2 sweeps per smoother call, 100 coarse sweeps) and
  mgcg (50 coarse sweeps) the all-reduce counts are EQUAL and the port's
  halo counts are the reference's plus exactly the sweeps it leaves out
  (ROADMAP F11).  For every solve the live grand total equals
  ``comm.totals(k, replacements)``: every iteration communicates the same.
* Health: statuses, heartbeat iteration lists, the per-rank final-health
  events and their residual tails equal the reference's (tails to rtol
  1e-6 or a tenth of tol, as the histories of ``tests/_poisson_ref.py``),
  for a watched cg, MAX_ITERATIONS, a STAGNATED early exit (the same
  iteration), and mg, pt and pipecg under a heartbeat.
* The apps' ``heartbeat=``/``flight_dir=`` fields and their spans
  (``heat3d.run``, ``poisson.solve.<method>``, ``stokes.velocity_solve``,
  ``twophase.run``).
* Zero cost: cg, pipecg, mg and pt read the host exactly once per
  iteration, and as often in all, with and without ``watch()`` and a
  counting session, and the watched, counted iterate is bitwise the plain
  one.

The reference runs once, in a module-scoped child process with 8 fake CPU
devices; its numbers travel as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import fields, solvers  # noqa: E402
from repro_torch import telemetry as tele  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.telemetry import health  # noqa: E402
from repro_torch.telemetry.counters import (  # noqa: E402
    CounterSnapshot, counting, halo_slab_bytes, record_all_reduce, tag,
)

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
TOL = 1e-8

# name: (Poisson3D.solve method, solve kwargs); "mgcg1" is cg with a
# one-sweep cycle preconditioner (built in each package)
SOLVES = {
    "cg": ("cg", {}), "pipecg": ("pipecg", {}), "mgcg": ("mgcg", {}),
    "pipemgcg": ("pipemgcg", {}), "mg": ("mg", {}), "pt": ("pt", {}),
    "mg1": ("mg", {"nu_pre": 1, "nu_post": 1, "coarse_sweeps": 1}),
    "mgcg1": (None, {}),
}

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro import fields, solvers, telemetry as tele
from repro.apps.poisson import Poisson3D
from repro.core import init_global_grid

out = {{"halo": {{}}, "comm": {{}}, "health": {{}}}}

# -- one update_halo: center, face, width 2
def count_one(g, A, upd):
    sm = jax.shard_map(upd, mesh=g.mesh, in_specs=(g.spec,), out_specs=g.spec, check_vma=False)
    with tele.counting() as col:
        jax.eval_shape(sm, A)
    return col.stats().setup.as_dict()

g = init_global_grid(10, 12, 14, dims=(2, 2, 2))
out["halo"]["center"] = count_one(g, g.zeros(), lambda A: g.update_halo(A))
out["halo"]["xface"] = count_one(g, fields.zeros(g, "xface"), lambda F: fields.update_halo(g, F))
g2 = init_global_grid(10, 12, 14, dims=(2, 2, 2), overlap=4)
out["halo"]["w2"] = count_one(g2, g2.zeros(), lambda A: g2.update_halo(A))

# -- comm counts of every solve
app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2))
solves = {solves!r}
for name, (method, kw) in solves.items():
    with tele.session():
        if method is None:
            M = solvers.CyclePreconditioner(app.grid, app.spacing, coarse_sweeps=1)
            x, info = solvers.cg(app.grid, app.apply_A, app.b, tol={tol}, maxiter=2000,
                                 args=(app.c,), apply_M=M)
        else:
            x, info = app.solve(method, tol={tol}, **kw)
    out["comm"][name] = info.comm.as_dict(info.iterations, info.replacements)
    out["comm"][name]["replacements_run"] = info.replacements

# -- health
def events(sink, kind):
    return [e for e in sink.events if e.get("type") == kind]

h = out["health"]
_, plain = app.solve(method="cg", tol={tol})
h["plain"] = plain.status.name
for name, method, every in (("cg", "cg", 10), ("pipecg", "pipecg", 10), ("mg", "mg", 5),
                            ("pt", "pt", 50)):
    sink = tele.MemorySink()
    with tele.session(sink=sink), tele.watch(heartbeat_every=every):
        _, w = app.solve(method=method, tol={tol})
    jax.effects_barrier()
    h[name] = {{"status": w.status.name, "iterations": w.iterations, "relres": w.relres,
               "heartbeats": [(e["rank"], e["iteration"], e["relres"])
                              for e in events(sink, "heartbeat")],
               "finals": [(e["rank"], e["status"], e["iteration"], e["relres"],
                           e["residual_tail"]) for e in events(sink, "health")]}}
with tele.watch():
    _, m = app.solve(method="cg", tol=1e-14, maxiter=3)
h["maxiter"] = [m.status.name, m.iterations]
with tele.watch(stagnation_window=5, stagnation_rtol=0.9):
    _, s = app.solve(method="cg", tol=1e-30, maxiter=500)
h["stagnated"] = [s.status.name, s.iterations]
with tele.watch(divergence_factor=1e-3):
    _, d = app.solve(method="cg", tol=1e-30, maxiter=500)
h["diverged"] = [d.status.name, d.iterations]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run(REFERENCE.format(solves=SOLVES, tol=TOL), ndev=8)
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def app():
    return Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")


def solve(app, name, **extra):
    method, kw = SOLVES[name]
    if method is None:
        M = solvers.CyclePreconditioner(app.grid, app.spacing, coarse_sweeps=1)
        return solvers.cg(app.grid, app.apply_A, app.b, tol=TOL, maxiter=2000,
                          args=(app.c,), apply_M=M, **extra)
    return app.solve(method, tol=TOL, **kw, **extra)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_halo_slab_bytes_formula():
    shape = (10, 14, 18)
    for dim in range(3):
        face = np.prod([n for d, n in enumerate(shape) if d != dim])
        for width, itemsize in ((1, 8), (2, 4)):
            assert halo_slab_bytes(shape, dim, width, itemsize) == 2 * width * face * itemsize


def test_counter_snapshot_arithmetic():
    setup = CounterSnapshot()
    setup.add_halo(0, 100)
    setup.add_all_reduce(3)
    per_it = CounterSnapshot()
    per_it.add_halo(0, 100)
    per_it.add_halo(1, 40)
    per_it.add_all_reduce(1)
    per_it.add_all_reduce(1)
    tot = tele.CommStats(setup, per_it).totals(10)
    assert tot.halo_exchanges == 1 + 10 * 2
    assert tot.halo_bytes == 100 + 10 * 140
    assert tot.all_reduces == 1 + 10 * 2
    assert tot.all_reduce_scalars == 3 + 10 * 2
    assert tot.halo_per_dim[0] == {"exchanges": 11, "bytes": 1100}
    assert tot.halo_per_dim[1] == {"exchanges": 10, "bytes": 400}
    json.dumps(tele.CommStats(setup, per_it).as_dict(iterations=10))


def test_tag_innermost_collector_only():
    with counting() as outer:
        record_all_reduce(1)
        with counting() as inner:
            with tag("iteration"):
                record_all_reduce(1)
        record_all_reduce(1)
    assert outer.stats().setup.all_reduces == 2
    assert outer.stats().per_iteration.all_reduces == 0
    assert inner.stats().per_iteration.all_reduces == 1


def test_tag_nested_same_name_unwinds_by_position():
    with counting() as col:
        with tag("iteration"):
            with tag("solve"):
                with tag("iteration"):
                    record_all_reduce(1)
                assert col.tags == ["iteration", "solve"]
                record_all_reduce(1)
            record_all_reduce(1)
        assert col.tags == []
        record_all_reduce(1)
    assert col.buckets["iteration"].all_reduces == 2
    assert col.buckets["solve"].all_reduces == 1
    assert col.buckets["setup"].all_reduces == 1


def test_tag_first_occurrence_and_live_total():
    """per_iteration is the first iteration's counts; the live total sums
    every bucket over every occurrence."""
    with counting() as col:
        record_all_reduce(2)
        for k in range(4):
            with tag("iteration"):
                for _ in range(k + 1):
                    record_all_reduce(1)
    st = col.stats()
    assert st.per_iteration.all_reduces == 1 and st.setup.all_reduce_scalars == 2
    assert col.total().all_reduces == 1 + 1 + 2 + 3 + 4
    assert tele.count_comm(lambda: record_all_reduce(5)).setup.all_reduce_scalars == 5


def test_a_eff_t_eff():
    assert tele.a_eff(100, 1, 1, 4) == 3 * 100 * 4
    assert tele.t_eff(2e9, 1.0) == 2.0
    assert np.isnan(tele.t_eff(1.0, 0.0))


def test_sinks_serialize():
    tele.NullSink().emit({"type": "span"})
    sink = tele.MemorySink()
    with tele.session(sink=sink):
        with tele.region("outer", label="x"):
            with tele.region("inner"):
                pass
            tele.metric("t_eff_gbs", 12.5)
    assert [e["type"] for e in sink.events] == ["span", "metric", "span"]
    ct = sink.chrome_trace_events()
    assert [e["ph"] for e in ct] == ["X", "i", "X"]
    for e in ct:
        json.dumps(e)
    spans = [e for e in ct if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in spans)
    inner, = (e for e in spans if e["name"] == "inner")
    outer, = (e for e in spans if e["name"] == "outer")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"label": "x"}


def test_chrome_trace_sink_perfetto_loadable(tmp_path):
    path = tmp_path / "trace.json"
    sink = tele.ChromeTraceSink(str(path))
    with tele.session(sink=sink):
        with tele.region("a"):
            with tele.region("b"):
                pass
            tele.metric("m", 1.0)
        with tele.region("c", sync=torch.zeros(3)):
            pass
    sink.close()
    trace = json.loads(path.read_text())
    assert trace["displayTimeUnit"] == "ms"
    evs = trace["traceEvents"]
    assert all(e["ph"] in ("X", "i") for e in evs)
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int) and e["ts"] >= 0
    assert len({(e["pid"], e["tid"]) for e in evs}) == 1
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"a", "b", "c"}
    assert spans["a"]["ts"] <= spans["b"]["ts"]
    assert spans["b"]["ts"] + spans["b"]["dur"] <= spans["a"]["ts"] + spans["a"]["dur"] + 1.0
    assert spans["c"]["ts"] >= spans["a"]["ts"] + spans["a"]["dur"] - 1.0
    (inst,) = [e for e in evs if e["ph"] == "i"]
    assert spans["a"]["ts"] <= inst["ts"] <= spans["a"]["ts"] + spans["a"]["dur"] + 1.0


def test_jsonl_sink_empty_session_and_close_twice(tmp_path):
    empty = tmp_path / "empty.jsonl"
    sink = tele.JsonlSink(str(empty))
    with tele.session(sink=sink):
        pass
    sink.close()
    sink.close()
    assert empty.read_text() == ""
    full = tmp_path / "one.jsonl"
    sink2 = tele.JsonlSink(str(full))
    with tele.session(sink=sink2) as s:
        s.metric("x", 1.5)
    sink2.close()
    lines = full.read_text().splitlines()
    assert len(lines) == 1
    ev = json.loads(lines[0])
    assert ev["type"] == "metric" and ev["name"] == "x" and ev["value"] == 1.5


def test_flight_recorder_composes_with_sessions(tmp_path):
    from repro_torch.telemetry.flight import current as flight_current

    sink = tele.MemorySink()
    with tele.session(sink=sink) as s:
        with tele.flight(str(tmp_path), capacity=4) as rec:
            with tele.flight(str(tmp_path / "ignored")) as rec2:
                assert rec2 is rec
            assert flight_current() is rec
            with tele.region("r1"):
                with tele.region("r2"):
                    pass
            assert tele.current_session() is s
            for i in range(10):
                rec.record({"type": "tick", "i": i})
        assert flight_current() is None
    assert [e["name"] for e in sink.events if e["type"] == "span"] == ["r2", "r1"]
    evs = rec.events(rec.host_rank)
    assert [e["i"] for e in evs] == [6, 7, 8, 9]
    assert rec.dump_count == 0 and not list(tmp_path.glob("flight-*.jsonl"))


def test_flight_recorder_dumps_on_exception(tmp_path):
    with pytest.raises(RuntimeError):
        with tele.flight(str(tmp_path), meta={"app": "t"}) as rec:
            rec.record({"type": "tick", "i": 0})
            raise RuntimeError("boom")
    (path,) = sorted(tmp_path.glob("flight-rank*.jsonl"))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    header, events = lines[0], lines[1:]
    assert header["type"] == "flight_header" and header["reason"] == "exception:RuntimeError"
    assert header["meta"] == {"app": "t"} and "host_peak_rss_kb" in header["memory"]
    assert [e["type"] for e in events] == ["tick", "exception"]
    assert "boom" in events[-1]["error"]


def test_observe_composes_flight_and_watch(tmp_path):
    from repro_torch.telemetry.flight import current as flight_current

    with tele.observe():
        assert flight_current() is None and not tele.watching()
    with tele.observe(heartbeat=5, flight_dir=str(tmp_path), stagnation_window=7):
        cfg = health.current()
        assert cfg.heartbeat_every == 5 and cfg.stagnation_window == 7
        rec = flight_current()
        assert rec is not None
        with tele.observe(heartbeat=50, flight_dir=str(tmp_path / "x")):
            assert health.current() is cfg and flight_current() is rec
    assert flight_current() is None and not tele.watching()


def test_region_noop_and_session_reentrant():
    assert not tele.enabled() and tele.current_session() is None
    with tele.region("nothing"):
        pass
    outer_sink = tele.MemorySink()
    with tele.session(sink=outer_sink) as outer:
        with tele.session(sink=tele.MemorySink()) as inner:
            assert inner is outer
            inner.metric("nested", 1.0)
        assert tele.current_session() is outer
    assert tele.current_session() is None
    assert [e["name"] for e in outer_sink.events] == ["nested"]


# ---------------------------------------------------------------------------
# communication counts against the reference
# ---------------------------------------------------------------------------

def _snapshot(col):
    return col.stats().setup.as_dict()


def test_halo_counts_match_reference(reference):
    g = init_global_grid(10, 12, 14, dims=(2, 2, 2), device="cpu")
    item = torch.empty(0, dtype=g.dtype).element_size()
    with counting() as col:
        g.update_halo(g.zeros())
    snap = col.stats().setup
    assert snap.halo_exchanges == 3
    for d in range(3):
        assert snap.halo_per_dim[d]["bytes"] == halo_slab_bytes(g.local_shape, d, g.halo, item)
    assert _snapshot(col) == reference["halo"]["center"]
    with counting() as colf:
        fields.update_halo(g, fields.zeros(g, "xface"))
    assert _snapshot(colf) == reference["halo"]["xface"]
    g2 = init_global_grid(10, 12, 14, dims=(2, 2, 2), overlap=4, device="cpu")
    with counting() as col2:
        g2.update_halo(g2.zeros())
    assert _snapshot(col2) == reference["halo"]["w2"]
    # a lead axis counts one block's slab: (*lead, *local)
    with counting() as col3:
        g.update_halo(torch.zeros((3,) + g.shape, dtype=g.dtype))
    assert col3.stats().setup.halo_bytes == 3 * snap.halo_bytes
    # skipped dims (one block, not periodic) record nothing, as in the reference
    g1 = init_global_grid(10, 12, 14, dims=(2, 1, 1), periodic=(False, True, False),
                          device="cpu")
    with counting() as col4:
        g1.update_halo(g1.zeros())
    assert sorted(col4.stats().setup.halo_per_dim) == [0, 1]


def _counted(app, name):
    with tele.session():
        return solve(app, name)


def _sweep_bytes(grid, level, d):
    """Halo bytes along dim ``d`` of one Jacobi sweep (one f64 update_halo)
    at a hierarchy level."""
    g = grid.hierarchy()[level]
    return halo_slab_bytes(g.local_shape, d, g.halo, 8)


def _sweeps_the_reference_leaves_out(grid, name):
    """(per_iteration, setup, per_replacement) extra sweeps, as {level: n}:
    every Jacobi call of ``n`` sweeps is one traced sweep there."""
    L = len(grid.hierarchy()) - 1
    if name == "mg":        # nu_pre = nu_post = 2 on every level but the last, 100 there
        return {**{lv: 2 for lv in range(L)}, L: 99}, {}, {}
    if name in ("mgcg", "pipemgcg"):   # one cycle per M, 50 coarse sweeps
        one = {L: 49}
        if name == "mgcg":
            return one, one, {}
        return one, {}, {L: 2 * 49}      # two M applications per replacement head
    return {}, {}, {}


def _add_sweeps(snap: dict, grid, extra: dict) -> dict:
    out = json.loads(json.dumps(snap))
    for level, n in extra.items():
        for d in range(3):
            b = n * _sweep_bytes(grid, level, d)
            out["halo_exchanges"] += n
            out["halo_bytes"] += b
            per = out["halo_per_dim"].setdefault(str(d), {"exchanges": 0, "bytes": 0})
            per["exchanges"] += n
            per["bytes"] += b
    return out


@pytest.mark.parametrize("name", list(SOLVES))
def test_comm_counts_match_reference(reference, app, name):
    ref = reference["comm"][name]
    x, info = _counted(app, name)
    c = info.comm
    assert c is not None and info.iterations == ref["iterations"]
    assert info.replacements == ref["replacements_run"]
    got = c.as_dict(info.iterations, info.replacements)
    per_it, setup, per_rep = _sweeps_the_reference_leaves_out(app.grid, name)
    assert got["per_iteration"] == _add_sweeps(ref["per_iteration"], app.grid, per_it)
    assert got["setup"] == _add_sweeps(ref["setup"], app.grid, setup)
    assert got["per_replacement"] == _add_sweeps(ref["per_replacement"], app.grid, per_rep)
    for key in ("all_reduces", "all_reduce_scalars"):
        assert got["totals"][key] == ref["totals"][key]
    if not (per_it or setup or per_rep):
        assert got == {k: v for k, v in ref.items() if k != "replacements_run"}


@pytest.mark.parametrize("name", list(SOLVES))
def test_live_total_equals_totals(app, name):
    """Counted as it ran, the whole solve equals setup + k * per_iteration +
    replacements * per_replacement: every iteration counted the same.
    Without a session the solver opens no collector of its own, so a plain
    ``counting()`` around it takes the whole live solve (pt's spectral
    bounds, two reductions of the app before the solver starts, are taken
    outside it)."""
    run = lambda: solve(app, name)  # noqa: E731
    if name == "pt":
        lo, hi = app.spectral_bounds()
        run = lambda: solvers.pseudo_transient(  # noqa: E731
            app.grid, app.apply_A, app.b, tol=TOL, maxiter=20000, args=(app.c,),
            lam_min=lo, lam_max=hi)
    with tele.session():
        _, info = run()
    with counting() as col:
        _, again = run()
    assert again.iterations == info.iterations and again.comm is None
    assert col.total().as_dict() == info.comm.totals(info.iterations, info.replacements).as_dict()


def test_no_session_no_counts(app):
    _, info = app.solve("cg", tol=TOL)
    assert info.comm is None and not tele.counting_enabled()


# ---------------------------------------------------------------------------
# health against the reference
# ---------------------------------------------------------------------------

def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.1 * tol)


@pytest.mark.parametrize("name,method,every", [("cg", "cg", 10), ("pipecg", "pipecg", 10),
                                               ("mg", "mg", 5), ("pt", "pt", 50)])
def test_watched_solve_matches_reference(reference, app, name, method, every):
    ref = reference["health"][name]
    _, plain = app.solve(method, tol=TOL)
    sink = tele.MemorySink()
    with tele.session(sink=sink), tele.watch(heartbeat_every=every):
        _, w = app.solve(method, tol=TOL)
    assert w.status.name == ref["status"] == "CONVERGED"
    assert w.iterations == ref["iterations"] == plain.iterations
    hb = [e for e in sink.events if e["type"] == "heartbeat"]
    assert [(e["rank"], e["iteration"]) for e in hb] == [(r, k) for r, k, _ in ref["heartbeats"]]
    assert len(hb) == w.iterations // every
    _close([e["relres"] for e in hb], [v for _, _, v in ref["heartbeats"]])
    finals = [e for e in sink.events if e["type"] == "health"]
    ref_finals = sorted(ref["finals"])      # the reference's callbacks land in any order
    assert [(e["rank"], e["status"], e["iteration"]) for e in finals] \
        == [(r, s, k) for r, s, k, _, _ in ref_finals]
    assert len(finals) == 8 and all(len(e["residual_tail"]) == health.TAIL for e in finals)
    for e, (_, _, _, relres, tail) in zip(finals, ref_finals):
        _close(e["residual_tail"], tail, tol=TOL if name != "pt" else TOL * tail[-1] / relres)
        _close(e["relres"], relres)


def test_statuses_match_reference(reference, app):
    h = reference["health"]
    _, plain = app.solve("cg", tol=TOL)
    assert plain.status.name == h["plain"]
    with tele.watch():
        _, m = app.solve("cg", tol=1e-14, maxiter=3)
    assert [m.status.name, m.iterations] == h["maxiter"] == ["MAX_ITERATIONS", 3]
    with tele.watch(stagnation_window=5, stagnation_rtol=0.9):
        _, s = app.solve("cg", tol=1e-30, maxiter=500)
    assert [s.status.name, s.iterations] == h["stagnated"]
    assert s.status == tele.SolveStatus.STAGNATED and s.iterations < 20
    with tele.watch(divergence_factor=1e-3):
        _, d = app.solve("cg", tol=1e-30, maxiter=500)
    assert [d.status.name, d.iterations] == h["diverged"]


# ---------------------------------------------------------------------------
# zero cost: one host read per iteration, bitwise iterates
# ---------------------------------------------------------------------------

_READS = ("__float__", "__int__", "__bool__", "item", "tolist", "numpy")


@contextlib.contextmanager
def host_reads():
    """Count the calls that move a tensor's value to the host."""
    n = [0]
    with pytest.MonkeyPatch.context() as mp:
        for attr in _READS:
            real = getattr(torch.Tensor, attr)

            def spy(self, *a, _real=real, **k):
                n[0] += 1
                return _real(self, *a, **k)

            mp.setattr(torch.Tensor, attr, spy)
        yield n


@pytest.mark.parametrize("method", ["cg", "pipecg", "mg", "pt"])
def test_one_host_read_per_iteration(app, method):
    def reads(maxiter, watched):
        ctx = contextlib.ExitStack()
        if watched:
            ctx.enter_context(tele.session())
            ctx.enter_context(tele.watch(heartbeat_every=1, stagnation_window=50,
                                         divergence_factor=1e6))
        with ctx, host_reads() as n:
            x, info = app.solve(method, tol=1e-30, maxiter=maxiter)
        assert info.iterations == maxiter
        return n[0], x

    counts = {}
    for watched in (False, True):
        n3, _ = reads(3, watched)
        n7, _ = reads(7, watched)
        assert n7 - n3 == 4, (watched, n3, n7)
        counts[watched] = n7
    assert counts[True] == counts[False]      # the epilogue reads nothing more either
    _, x_plain = reads(7, False)
    _, x_watched = reads(7, True)
    assert torch.equal(x_plain, x_watched)


# ---------------------------------------------------------------------------
# the apps' heartbeat / flight_dir fields and region spans
# ---------------------------------------------------------------------------

def _app_run(name, **kw):
    from repro_torch.apps import Heat3D, Stokes3D, TwoPhase3D

    if name == "heat3d":
        app = Heat3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), hide=None, device="cpu", **kw)
        return lambda: app.run(3), "heat3d.run"
    if name == "poisson":
        app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu", **kw)
        return lambda: app.solve("cg", tol=TOL), "poisson.solve.cg"
    if name == "stokes":
        app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu", **kw)
        return lambda: app.velocity_solve(precond="face", tol=1e-8), "stokes.velocity_solve"
    app = TwoPhase3D(nx=16, ny=12, nz=12, dims=(2, 2, 2), method="cg", device="cpu", **kw)
    return lambda: app.run(1), "twophase.run"


@pytest.mark.parametrize("name", ["heat3d", "poisson", "stokes", "twophase"])
def test_app_fields_and_spans(name, tmp_path):
    """Each app's entry point is one span under a session; ``heartbeat=``
    watches its solves (rank-0 heartbeats, one health event per rank) and
    ``flight_dir=`` installs a recorder that mirrors them (no dump on a
    healthy run)."""
    run, span = _app_run(name, heartbeat=2, flight_dir=str(tmp_path))
    sink = tele.MemorySink()
    with tele.session(sink=sink):
        run()
    assert [e["name"] for e in sink.events if e["type"] == "span"] == [span]
    from repro_torch.telemetry.flight import current as flight_current

    assert not tele.watching() and flight_current() is None     # nothing left installed
    beats = [e for e in sink.events if e["type"] == "heartbeat"]
    finals = [e for e in sink.events if e["type"] == "health"]
    if name == "heat3d":       # no solver: nothing to watch
        assert not beats and not finals
    else:
        assert beats and all(e["iteration"] % 2 == 0 for e in beats)
        assert {e["rank"] for e in finals} == set(range(8))
    assert not list(tmp_path.glob("flight-*.jsonl"))
