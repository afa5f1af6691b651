"""Stokes3D over gloo processes against the JAX package and the port in
one process.

``Stokes3D(nx=8, ny=8, nz=8)`` f64 on a 14^3 global grid of 2x2x2 blocks,
through its normal entry points in every process:

* the velocity solves (``tol=1e-8``) on 8 processes of one block each:
  iteration counts EQUAL to the reference's (precond ``"face"`` 17,
  ``"stress"`` 7, None 77, ``"center"`` 18, as ``tests/test_torch_stokes.py``
  holds them against the JAX package);
* the Schur-complement solves (``tol=1e-6``, the compiled schedule,
  ``"stress"`` 10 outer / 84 inner and ``"face"`` 10 / 193) and the Uzawa
  solve (52 / 212) on 2 processes of 4 blocks each are in
  ``tests/test_torch_dist_stokes_{schur,uzawa}.py``.

Each run and its one-process counterpart (a group of one process) run at
the same time, each in its own processes, beside the reference's velocity
solves on 8 fake devices (``tests/_stokes_ref.py``; the port's viscosity
and forcing equal the reference's to 1e-14, ``tests/test_torch_stokes.py``):
the fields gathered from the 8 processes are held against the reference's
by the rules of ``tests/test_torch_stokes.py`` (counts EQUAL, residual
histories within rtol 1e-6 or atol ``0.1 * tol``, every component within
1e-10 of the reference's largest value).  The unpreconditioned solve's
history is held to the one-process port's and not to the reference's: its
last iterations move by more than ``0.1 * tol`` with the order of the sums
(F5; the 8 processes' tail differs from the reference's by about
``0.5 * tol``, more than the reference's own 1-vs-8-block spread, while
its first 54 entries agree to 1e-13 of their value).

Nothing here is bitwise: every Krylov iteration reads dot products, and a
process group adds the processes' partial sums in another order than one
process adds its blocks (F5 of ``ROADMAP.md``).  So the iterates are held
to F5's tolerance: residual histories within rtol 1e-6 or atol ``0.1 *
tol``, fields within 1e-10 of their largest value.  Every process reads
the same counts, histories and gathered fields.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _stokes_ref import TOL, reference_velocity_solves  # noqa: E402

COMPS = ("vx", "vy", "vz")
VELOCITY = {"face": 17, "stress": 7, None: 77, "center": 18}
OUTER = {  # name: (solve kwargs, outer, inner)
    "schur_face": (dict(method="schur", precond="face"), 10, 193),
    "schur_stress": (dict(method="schur", precond="stress"), 10, 84),
    "uzawa": (dict(method="uzawa"), 52, 212),
}


def _gathered(V, P=None):
    from repro_torch import fields
    out = {k: fields.gather(V[k]) for k in COMPS}
    if P is not None:
        out["P"] = fields.gather(P)
    return out


def velocity_solves(rank: int, world: int) -> dict:
    """The four velocity solves (one block per process under a group)."""
    from repro_torch.apps import Stokes3D
    app = Stokes3D(nx=8, ny=8, nz=8, dims=None if world > 1 else (2, 2, 2), device="cpu")
    out = {}
    for precond in VELOCITY:
        V, info = app.velocity_solve(precond=precond, tol=1e-8)
        out[str(precond)] = dict(iterations=info.iterations, residuals=info.residuals,
                                 fields=_gathered(V),
                                 stacked={k: app.grid.to_stacked(V[k].data) for k in COMPS})
    return out


def outer_solves(rank: int, world: int, names) -> dict:
    """Schur and Uzawa solves on 2x2x2 blocks (4 per process on 2)."""
    from repro_torch.apps import Stokes3D
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu")
    out = {}
    for name in names:
        V, P, info = app.solve(tol=1e-6, **OUTER[name][0])
        out[name] = dict(outer=info.outer_iterations, inner=info.inner_iterations,
                         relres_div=info.relres_div, relres_momentum=info.relres_momentum,
                         fields=_gathered(V, P))
    return out


def run_parallel(tmp, jobs: dict) -> dict:
    """``{key: (processes, "module:function", *args)}`` spawned at once;
    returns ``{key: per-process results}``."""
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(spawn, P, target, tmp, *args, timeout=400)
                for k, (P, target, *args) in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist_stokes")
    ref = tmp_path_factory.mktemp("torch_dist_stokes_reference")
    solves = {str(p): ("full", "noslip", p, "classic") for p in VELOCITY}
    with ThreadPoolExecutor(1) as ex:
        meta = ex.submit(reference_velocity_solves, ref, solves)
        out = run_parallel(tmp, {("velocity", P): (P, "test_torch_dist_stokes:velocity_solves")
                                 for P in (8, 1)})
        out["reference"] = ref, meta.result()
    return out


def _close_fields(got: dict, want: dict, what: str):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-10 * scale, err_msg=f"{what} {k}")


def _same_on_every_process(results: list, key: str):
    first = results[0][key]
    for r in results[1:]:
        for k, v in first.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(r[key][k][kk], vv, err_msg=f"{key} {k} {kk}")
            else:
                np.testing.assert_array_equal(r[key][k], v, err_msg=f"{key} {k}")


@pytest.mark.parametrize("precond", list(VELOCITY), ids=str)
def test_velocity_solve_on_8_processes(runs, precond):
    procs, one = runs[("velocity", 8)], runs[("velocity", 1)][0]
    key = str(precond)
    _same_on_every_process(procs, key)
    got, want = procs[0][key], one[key]
    assert got["iterations"] == want["iterations"] == VELOCITY[precond]
    np.testing.assert_allclose(got["residuals"], want["residuals"], rtol=1e-6, atol=1e-9)
    _close_fields(got["fields"], want["fields"], key)
    # the JAX package's solve of the same configuration on 8 devices
    tmp, meta = runs["reference"]
    assert got["iterations"] == meta[key]["iterations"]
    if precond is not None:
        np.testing.assert_allclose(got["residuals"], meta[key]["residuals"], rtol=1e-6,
                                   atol=0.1 * TOL)
    refs = {k: np.load(tmp / f"V_{key}_{k}.npy") for k in COMPS}
    scale = max(np.abs(r).max() for r in refs.values())
    for k in COMPS:
        np.testing.assert_allclose(got["stacked"][k], refs[k], rtol=0, atol=1e-10 * scale,
                                   err_msg=f"{key} {k} against the reference")


def check_outer(procs: list, one: dict, name: str):
    _same_on_every_process(procs, name)
    got, want = procs[0][name], one[name]
    _, outer, inner = OUTER[name]
    assert (got["outer"], got["inner"]) == (want["outer"], want["inner"]) == (outer, inner)
    assert got["relres_div"] <= 1e-6 and got["relres_momentum"] < 1e-4
    np.testing.assert_allclose(got["relres_div"], want["relres_div"], rtol=1e-6, atol=1e-7)
    _close_fields(got["fields"], want["fields"], name)

