"""Poisson3D over 8 gloo processes, one block each, against the JAX
package's and against the port in one process.

Local 10^3, ``dims=(2, 2, 2)``, f64, ``tol=1e-8``, through
``Poisson3D.solve`` in every process.  Held (``tests/_poisson_ref.py``):

* iteration counts EQUAL to the reference's: Dirichlet cg 54, pipecg 55,
  mgcg 12, mg 20; all-periodic cg 26, mgcg 10;
* residual histories within rtol 1e-6 or atol ``0.1 * tol`` of the
  reference's (F5 of ``ROADMAP.md``: the last CG iterations amplify
  rounding differences; the processes add their partial dots in another
  order than one process does);
* the solution within 1e-10 of the reference's and of the one-process
  port's, relative to its largest value, and the NumPy oracle (run by every
  process on the gathered arrays) agreeing with the one-process oracle
  to 1e-12;
* every process reads the same iteration count, history and gathered
  solution.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _poisson_ref import reference_solves  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402

TOL = 1e-8
CASES = {  # name: (periodic, method, tol, solver kwargs)
    "cg": (False, "cg", TOL, {}),
    "pipecg": (False, "pipecg", TOL, {}),
    "mgcg": (False, "mgcg", TOL, {}),
    "mg": (False, "mg", TOL, {}),
    "cg_periodic": (True, "cg", TOL, {}),
    "mgcg_periodic": (True, "mgcg", TOL, {}),
}
ITERATIONS = {"cg": 54, "pipecg": 55, "mgcg": 12, "mg": 20, "cg_periodic": 26,
              "mgcg_periodic": 10}


def poisson_solves(rank: int, world: int, cases: dict) -> dict:
    """What each process runs (with ``world == 1`` and no group, the
    one-process port)."""
    out, apps = {}, {}
    for name, (per, method, tol, kw) in cases.items():
        if per not in apps:
            apps[per] = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=(per,) * 3,
                                  device="cpu")
            out[f"oracle_{per}"] = apps[per].oracle(tol=1e-12)
        app = apps[per]
        u, info = app.solve(method, tol=tol, **kw)
        out[name] = dict(iterations=info.iterations, residuals=info.residuals,
                         relres=info.relres, converged=info.converged,
                         stacked=app.grid.to_stacked(u), gather=app.grid.gather(u),
                         residual_norm=app.residual_norm(u))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_poisson")
    ref = {}

    def reference():
        try:
            ref["meta"] = reference_solves(tmp, CASES)
        except BaseException as e:   # re-raised in the test thread
            ref["error"] = e

    t = threading.Thread(target=reference)
    t.start()
    per_rank = spawn(8, "test_torch_dist_poisson:poisson_solves", tmp, CASES, timeout=300)
    t.join()
    if "error" in ref:
        raise ref["error"]
    return tmp, ref["meta"], per_rank, poisson_solves(0, 1, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_counts_and_histories_equal_the_reference(runs, name):
    tmp, meta, per_rank, _ = runs
    got, want = per_rank[0][name], meta[name]
    assert got["iterations"] == want["iterations"] == ITERATIONS[name]
    np.testing.assert_allclose(got["residuals"], want["residuals"], rtol=1e-6, atol=0.1 * TOL)
    ref = np.load(tmp / f"u_{name}.npy")
    assert np.abs(got["stacked"] - ref).max() / np.abs(ref).max() < 1e-10
    assert got["converged"] and got["relres"] <= TOL and got["residual_norm"] < 2 * TOL


@pytest.mark.parametrize("name", list(CASES))
def test_agrees_with_the_one_process_port(runs, name):
    _, _, per_rank, one = runs
    want = one[name]
    for r, got in enumerate(per_rank):
        got = got[name]
        assert got["iterations"] == want["iterations"], r
        np.testing.assert_allclose(got["residuals"], want["residuals"], rtol=1e-6,
                                   atol=0.1 * TOL)
        err = np.abs(got["stacked"] - want["stacked"]).max() / np.abs(want["stacked"]).max()
        assert err < 1e-10, (r, err)
        # every process reads the same values
        np.testing.assert_array_equal(got["residuals"], per_rank[0][name]["residuals"])
        np.testing.assert_array_equal(got["gather"], per_rank[0][name]["gather"])


@pytest.mark.parametrize("per", [False, True])
def test_oracle_on_gathered_arrays(runs, per):
    tmp, _, per_rank, one = runs
    for got in per_rank:
        np.testing.assert_allclose(got[f"oracle_{per}"], one[f"oracle_{per}"], rtol=0,
                                   atol=1e-12 * np.abs(one[f"oracle_{per}"]).max())
    G = np.load(tmp / f"oracle_{per}.npy")
    assert np.abs(per_rank[0][f"oracle_{per}"] - G).max() / np.abs(G).max() < 1e-10
