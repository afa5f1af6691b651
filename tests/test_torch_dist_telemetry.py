"""Solver telemetry and checkpoints of the grid across gloo processes,
against the port in one process at the same global ``dims``.

* Comm counts: cg, pipecg and mgcg of ``Poisson3D(nx=10, dims=(2, 2, 2))``
  under a session on 8 processes count, in every process, what one block
  sends: ``info.comm`` (setup, per iteration, per replacement, totals) and
  the live grand total EQUAL the one-process run's.
* Health events: under ``watch(heartbeat_every=5)`` the heartbeats come
  from the process holding block 0 only, equal to the one-process run's,
  and each process emits the final-health event of its own block.
* The NaN story of ``tests/test_torch_fault_tolerance.py`` on 8 processes
  of one block and on 2 processes of 4 blocks: each process dumps its own
  blocks' ``flight-rank<NNNN>.jsonl`` and no file is written by two
  processes; the file names, the per-rank
  final-health events and the verdicts ``diag`` prints equal the
  one-process run's, and ``diag`` merges them into one trace.
* Checkpoints: a state (a field tensor, a ``FieldSet``, the gathered
  global array, a step counter) saved on 8 processes, and saved again by
  ``async_save``, restores bitwise on one process and on 2 processes,
  and through the gathered array onto ``dims=(1, 1, 1)``; a one-process
  file restores on 2 processes.
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

from _dist import spawn  # noqa: E402
from repro_torch import ckpt  # noqa: E402
from repro_torch import telemetry as tele  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.fields import Field, FieldSet  # noqa: E402
from repro_torch.telemetry import diag  # noqa: E402
from repro_torch.telemetry.flight import current as flight_current  # noqa: E402

POISON = (1, 0, 0, 4, 4, 4)     # block (1, 0, 0), local cell (4, 4, 4)


def counts(rank: int, world: int) -> dict:
    """Comm counts and health events of the solves (also run with one
    process, no group)."""
    app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    out = {}
    for method in ("cg", "pipecg", "mgcg"):
        with tele.session():
            _, info = app.solve(method, tol=1e-8)
        with tele.counting() as col:     # without a session: the whole live solve
            app.solve(method, tol=1e-8)
        out[method] = dict(comm=info.comm.as_dict(info.iterations, info.replacements),
                           live=col.total().as_dict(), iterations=info.iterations)
    sink = tele.MemorySink()
    with tele.session(sink=sink), tele.watch(heartbeat_every=5):
        app.solve("cg", tol=1e-8)
    out["events"] = [{k: v for k, v in e.items() if k not in ("wall", "ts")}
                     for e in sink.events if e["type"] in ("heartbeat", "health")]
    return out


def nan_story(rank: int, world: int, fdir: str) -> dict:
    """A healthy cg solve, then one with a NaN in the coefficient of block
    (1, 0, 0); the failed solve dumps the flight records."""
    app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    with tele.session(), tele.observe(heartbeat=5, flight_dir=fdir):
        _, good = app.solve(method="cg", tol=1e-8)
        c = app.c.clone()
        blocks = [tuple(int(i) for i in np.unravel_index(r, app.grid.dims))
                  for r in app.grid.topo.block_ranks()]
        if POISON[:3] in blocks:
            c[np.unravel_index(blocks.index(POISON[:3]), app.grid.local_dims)
              + POISON[3:]] = float("nan")
        app.c = c
        _, bad = app.solve(method="cg", tol=1e-8)
        dumped = sorted(os.path.basename(p) for p in flight_current().dumped_paths)
    return dict(good=(good.status.name, good.iterations), bad=(bad.status.name, bad.iterations),
                dumped=dumped)


def _state(grid):
    G = np.random.RandomState(0).rand(*grid.global_shape)
    u = grid.scatter(G)
    F = FieldSet(vx=Field(grid, grid.scatter(G[::-1].copy()), "xface"),
                 p=Field(grid, grid.scatter(2.0 * G)))
    return {"u": u, "G": grid.gather(u), "F": F, "iteration": torch.tensor(123)}


def _like(grid):
    return {"u": grid.zeros(), "G": np.zeros(grid.global_shape),
            "F": FieldSet(vx=Field(grid, grid.zeros(), "xface"), p=Field(grid, grid.zeros())),
            "iteration": torch.tensor(0)}


def _ckpt_grid():
    return init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=torch.float64, device="cpu")


def save_state(rank: int, world: int, ckdir: str) -> str:
    grid = _ckpt_grid()
    state = _state(grid)
    path = ckpt.save(state, 7, ckdir, grid=grid)
    fut = ckpt.async_save({"u": state["u"]}, 8, ckdir, grid=grid)
    state["u"].fill_(-1.0)     # the copy was taken before async_save returned
    fut.result(timeout=60)
    return path


def restore_state(rank: int, world: int, ckdir: str) -> dict:
    grid = _ckpt_grid()
    out = {}
    for step in (7, 8):
        like = _like(grid) if step == 7 else {"u": grid.zeros()}
        back = ckpt.restore(like, step, ckdir, grid=grid)
        out[step] = {"u": grid.to_stacked(back["u"]), "local": tuple(back["u"].shape)}
        if step == 7:
            out[step].update(G=back["G"].numpy(), iteration=int(back["iteration"]),
                             vx=grid.to_stacked(back["F"].vx.data),
                             vx_loc=back["F"].vx.loc, p=grid.to_stacked(back["F"].p.data))
    return out


# ---------------------------------------------------------------------------
# comm counts and health events
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    return spawn(8, "test_torch_dist_telemetry:counts", tmp_path_factory.mktemp("counts"),
                 timeout=240), counts(0, 1)


@pytest.mark.parametrize("method", ["cg", "pipecg", "mgcg"])
def test_comm_counts_equal_the_one_process_run(counted, method):
    per_rank, one = counted
    for got in per_rank:
        assert got[method]["iterations"] == one[method]["iterations"]
        assert got[method]["comm"] == one[method]["comm"]
        assert got[method]["live"] == one[method]["live"] == one[method]["comm"]["totals"]


def test_heartbeats_from_block_zero_and_final_events_per_block(counted):
    per_rank, one = counted
    hb = [e for e in one["events"] if e["type"] == "heartbeat"]
    assert hb and all(e["rank"] == 0 for e in hb)
    finals = {e["rank"]: e for e in one["events"] if e["type"] == "health"}
    assert sorted(finals) == list(range(8))
    for r, got in enumerate(per_rank):
        got_hb = [e for e in got["events"] if e["type"] == "heartbeat"]
        got_final = [e for e in got["events"] if e["type"] == "health"]
        assert [e["iteration"] for e in got_hb] == ([e["iteration"] for e in hb] if r == 0
                                                    else [])
        for e, want in zip(got_hb, hb):
            assert e["relres"] == pytest.approx(want["relres"], rel=1e-6)
        assert [e["rank"] for e in got_final] == [r]
        e, want = got_final[0], finals[r]
        assert (e["status"], e["iteration"], e["solver"]) \
            == (want["status"], want["iteration"], want["solver"])
        np.testing.assert_allclose(e["residual_tail"], want["residual_tail"], rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# flight records and diag
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stories(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nan_story")
    out = {}
    for name, world in (("8x1", 8), ("2x4", 2)):
        fdir = str(tmp / name)
        out[name] = fdir, spawn(world, "test_torch_dist_telemetry:nan_story", tmp, fdir,
                                timeout=240)
    fdir = str(tmp / "one")
    out["one"] = fdir, [nan_story(0, 1, fdir)]
    return out


def _verdicts(fdir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert diag.main([fdir, "--out", os.path.join(fdir, "trace.json")]) == 0
    lines = buf.getvalue().splitlines()
    # the per-rank rows and their last-health verdicts (not the timings)
    return [ln.split(":")[0] + ln.split(")")[-1] if "events, dumped" in ln else ln
            for ln in lines if "events, dumped" in ln or "last health" in ln]


def _finals(fdir):
    out = {}
    for p in sorted(glob.glob(os.path.join(fdir, "flight-rank*.jsonl"))):
        with open(p) as f:
            evs = [json.loads(ln) for ln in f]
        out[os.path.basename(p)] = (evs[0]["reason"], [
            {k: v for k, v in e.items() if k != "wall"} for e in evs[1:] if e["type"] == "health"])
    return out


@pytest.mark.parametrize("layout", ["8x1", "2x4"])
def test_flight_records_merge_to_the_one_process_verdicts(stories, layout):
    fdir, per_rank = stories[layout]
    one_dir, one = stories["one"]
    assert one[0]["bad"][0] == "DIVERGED_NONFINITE"
    assert all(r["good"] == one[0]["good"] and r["bad"] == one[0]["bad"] for r in per_rank)
    got, want = _finals(fdir), _finals(one_dir)
    assert list(got) == list(want) == [f"flight-rank{r:04d}.jsonl" for r in range(8)]
    # no two processes write one file
    written = [name for r in per_rank for name in r["dumped"]]
    assert sorted(written) == list(got)
    for name in want:
        assert got[name][0] == want[name][0] == "status:DIVERGED_NONFINITE"
        assert len(got[name][1]) == len(want[name][1]) == 2, name   # good and bad solve
        for e, w in zip(got[name][1], want[name][1]):
            assert {k: v for k, v in e.items() if k not in ("relres", "residual_tail")} \
                == {k: v for k, v in w.items() if k not in ("relres", "residual_tail")}
            np.testing.assert_allclose(e["residual_tail"], w["residual_tail"], rtol=1e-6,
                                       atol=1e-9, equal_nan=True)
    assert _verdicts(fdir) == _verdicts(one_dir)
    with open(os.path.join(fdir, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    assert {e["pid"] for e in evs} == set(range(8))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    paths = spawn(8, "test_torch_dist_telemetry:save_state", tmp, str(tmp / "eight"),
                  timeout=240)
    one = _ckpt_grid()
    ckpt.save(_state(one), 7, str(tmp / "one"))
    ckpt.save({"u": _state(one)["u"]}, 8, str(tmp / "one"))
    return tmp, paths


def test_saved_on_eight_restores_on_one(saved):
    tmp, paths = saved
    assert len(set(paths)) == 1 and ckpt.latest_step(str(tmp / "eight")) == 8
    grid = _ckpt_grid()
    want = _state(grid)
    back = ckpt.restore(_like(grid), 7, str(tmp / "eight"))
    assert torch.equal(back["u"], want["u"]) and back["u"].shape == grid.full_shape
    np.testing.assert_array_equal(back["G"].numpy(), want["G"])
    assert torch.equal(back["F"].vx.data, want["F"].vx.data) and back["F"].vx.loc == "xface"
    assert torch.equal(back["F"].p.data, want["F"].p.data) and int(back["iteration"]) == 123
    assert torch.equal(ckpt.restore({"u": grid.zeros()}, 8, str(tmp / "eight"))["u"], want["u"])
    # the files are those of the same state saved by one process
    for name in ("u", "G", "F__0__0", "F__1__0", "iteration"):
        np.testing.assert_array_equal(np.load(tmp / "eight" / "step_00000007" / f"{name}.npy"),
                                      np.load(tmp / "one" / "step_00000007" / f"{name}.npy"))
    g1 = init_global_grid(14, 10, 10, dims=(1, 1, 1), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(g1.gather(g1.scatter(back["G"].numpy())), grid.gather(want["u"]))


@pytest.mark.parametrize("src", ["eight", "one"])
def test_restores_on_two_processes(saved, src):
    tmp, _ = saved
    per_rank = spawn(2, "test_torch_dist_telemetry:restore_state", tmp, str(tmp / src),
                     timeout=240)
    grid = _ckpt_grid()
    want = _state(grid)
    for got in per_rank:
        assert got[7]["local"] == (1, 2, 2, 8, 6, 6)
        np.testing.assert_array_equal(got[7]["u"], grid.to_stacked(want["u"]))
        np.testing.assert_array_equal(got[8]["u"], grid.to_stacked(want["u"]))
        np.testing.assert_array_equal(got[7]["G"], want["G"])
        np.testing.assert_array_equal(got[7]["vx"], grid.to_stacked(want["F"].vx.data))
        np.testing.assert_array_equal(got[7]["p"], grid.to_stacked(want["F"].p.data))
        assert got[7]["vx_loc"] == "xface" and got[7]["iteration"] == 123
