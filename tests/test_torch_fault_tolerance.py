"""The solver-failure story of ``tests/test_fault_tolerance.py::
test_nan_solve_flight_records_diag_and_resume`` on the port, against the
reference's own run of it.

Two-rank ``Poisson3D(nx=10, ny=10, nz=10, dims=(2, 1, 1))`` under a
session and ``observe(heartbeat=5, flight_dir=...)``: a healthy cg solve
and a checkpoint of its iterate, then one interior coefficient cell of
block 1 poisoned with NaN.  The poisoned solve ends ``DIVERGED_NONFINITE``
within one iteration and leaves one flight record per rank behind.  The
port writes the SAME file names, header fields (``reason``, ``capacity``,
``n_events``, ``memory``, ``meta`` and the rest) and, per file, the same
sequence of event types as the reference for the same solves (timestamps
and wall clocks are not compared); its heartbeat iterations, statuses and
solve summaries equal the reference's (the poisoned solve ran no
iteration, so the port, counting live, has no per-iteration counts for
it; its setup and totals equal the reference's).  ``diag.main`` merges the files
into one trace with pids 0 and 1 and prints the imbalance report, and the
checkpoint restores to a warm solve of at most 5 iterations.

The serving path's flight recorder: ``Engine(flight_dir=...)`` on the
SMOKE Mamba-2 model gives the same ids as without it, and its dump holds
the ``serve.prefill`` and ``serve.decode`` spans.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import ckpt  # noqa: E402
from repro_torch import telemetry as tele  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402
from repro_torch.telemetry import diag  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

REFERENCE = ALIAS + """
import glob, json, os
jax.config.update("jax_enable_x64", True)
from repro import ckpt, telemetry as tele
from repro.apps.poisson import Poisson3D

out = {tmp!r}
fdir = os.path.join(out, "flight")
app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 1, 1))
with tele.session(), tele.observe(heartbeat=5, flight_dir=fdir):
    x, good = app.solve(method="cg", tol=1e-8)
    ckpt.save({{"x": x}}, 1, out)
    c = np.array(app.c)
    c[14, 4, 4] = np.nan
    app.c = jnp.asarray(c)
    x2, bad = app.solve(method="cg", tol=1e-8)
summary = {{"good": [good.status.name, good.iterations], "bad": [bad.status.name, bad.iterations],
           "files": {{}}}}
for p in sorted(glob.glob(os.path.join(fdir, "flight-rank*.jsonl"))):
    lines = [json.loads(ln) for ln in open(p)]
    summary["files"][os.path.basename(p)] = lines
print(json.dumps(summary, default=str))
"""

VOLATILE = ("wall", "epoch", "ts", "dur", "wall_s", "memory")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ft_ref"))
    out = run(REFERENCE.format(tmp=tmp), ndev=2)
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def story(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ft"))
    fdir = os.path.join(out, "flight")
    app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 1, 1), device="cpu")
    c_good = app.c
    with tele.session(), tele.observe(heartbeat=5, flight_dir=fdir):
        x, good = app.solve(method="cg", tol=1e-8)
        ckpt.save({"x": x}, 1, out)
        c = app.c.clone()
        c[1, 0, 0, 4, 4, 4] = float("nan")   # stacked [14, 4, 4]: block 1, local (4, 4, 4)
        app.c = c
        _, bad = app.solve(method="cg", tol=1e-8)
    return out, fdir, app, c_good, x, good, bad


def _records(fdir):
    files = sorted(glob.glob(os.path.join(fdir, "flight-rank*.jsonl")))
    out = {}
    for p in files:
        with open(p) as f:
            out[os.path.basename(p)] = [json.loads(ln) for ln in f]
    return out


def test_statuses_and_files_match_reference(reference, story):
    _, fdir, _, _, _, good, bad = story
    assert [good.status.name, good.iterations] == reference["good"]
    assert good.status == tele.SolveStatus.CONVERGED
    assert [bad.status.name, bad.iterations] == reference["bad"]
    assert bad.status == tele.SolveStatus.DIVERGED_NONFINITE and bad.iterations <= 1
    got = _records(fdir)
    assert list(got) == list(reference["files"]) == ["flight-rank0000.jsonl",
                                                     "flight-rank0001.jsonl"]
    for name, lines in got.items():
        ref = reference["files"][name]
        header, ref_header = lines[0], ref[0]
        assert set(header) == set(ref_header)
        for key in ("type", "rank", "host_rank", "reason", "capacity", "n_events", "meta"):
            assert header[key] == ref_header[key], (name, key)
        assert header["reason"] == "status:DIVERGED_NONFINITE"
        assert header["n_events"] == len(lines) - 1
        assert "host_peak_rss_kb" in header["memory"]
        assert [e["type"] for e in lines[1:]] == [e["type"] for e in ref[1:]], name
        finals = [e for e in lines[1:] if e["type"] == "health"]
        assert any(e["status"] == "DIVERGED_NONFINITE" for e in finals), name


def test_events_match_reference(reference, story):
    """Every event's fields equal the reference's, timestamps aside: the
    heartbeat iterations, the spans' names and attributes, the solve
    summaries (with their comm dicts), the final-health verdicts."""
    _, fdir, _, _, _, _, _ = story
    for name, lines in _records(fdir).items():
        for got, want in zip(lines[1:], reference["files"][name][1:]):
            assert set(got) == set(want), (name, got["type"])
            for key in set(got) - set(VOLATILE):
                g, w = got[key], want[key]
                if key in ("relres", "residual_tail"):
                    np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float),
                                               rtol=1e-6, atol=1e-9, equal_nan=True)
                elif key == "meta":
                    assert g == {**w, "dims": g["dims"]} and list(g["dims"]) == list(w["dims"])
                elif key == "comm" and got["iterations"] == 0:
                    # counted live: a solve that ran no iteration counted none
                    assert g["per_iteration"]["halo_exchanges"] == 0
                    assert {k: v for k, v in g.items() if k != "per_iteration"} \
                        == {k: v for k, v in w.items() if k != "per_iteration"}
                else:
                    assert g == w, (name, got["type"], key)


def test_diag_merges_and_resume(story):
    out, fdir, app, c_good, x, _, _ = story
    trace_path = os.path.join(out, "trace.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = diag.main([fdir, "--out", trace_path])
    assert rc == 0
    report = buf.getvalue()
    assert "imbalance" in report and "DIVERGED_NONFINITE" in report
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    assert {e["pid"] for e in evs} == {0, 1}
    assert any(e["ph"] == "X" for e in evs) and any(e["ph"] == "i" for e in evs)
    app.c = c_good
    state = ckpt.restore({"x": x}, 1, out)
    assert torch.equal(state["x"], x)
    _, info = app.solve(method="cg", tol=1e-8, x0=state["x"])
    assert info.status == tele.SolveStatus.CONVERGED and info.iterations <= 5


def test_diag_cli_module(story):
    """``python -m repro_torch.telemetry.diag DIR --out TRACE`` as a command."""
    import subprocess

    out, fdir, _, _, _, _, _ = story
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    trace = os.path.join(out, "cli.json")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.diag", fdir,
                           "--out", trace], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
    assert "per-region load imbalance" in proc.stdout and os.path.exists(trace)
    empty = os.path.join(out, "empty")
    os.makedirs(empty)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.diag", empty],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 1 and "no flight-rank" in proc.stderr


def test_engine_flight_recorder(tmp_path):
    from repro_torch.configs.mamba2_1p3b import SMOKE
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    model = Model(SMOKE, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                  device="cpu")
    tokens = torch.randint(0, SMOKE.vocab, (2, 7), generator=torch.Generator().manual_seed(1))
    plain = Engine(SMOKE, model, device="cpu").generate(tokens, 5)
    eng = Engine(SMOKE, model, device="cpu", flight_dir=str(tmp_path))
    assert torch.equal(eng.generate(tokens, 5), plain)
    assert eng.recorder is not None
    (path,) = eng.recorder.dump(reason="manual")
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["meta"]["app"] == "serve"
    spans = {e["name"]: e for e in lines[1:] if e["type"] == "span"}
    assert set(spans) == {"serve.prefill", "serve.decode"}
    assert spans["serve.prefill"]["prompt_len"] == 7 and spans["serve.decode"]["n_new"] == 5
