"""The port's ``Poisson3D`` (Dirichlet; Krylov and pseudo-transient solves)
against the JAX package's, on ``Poisson3D(nx=10, ny=10, nz=10,
dims=(2, 2, 2))`` in f64 (18^3 global cells on 8 virtual ranks).

* ``c`` and ``b`` equal the reference's to 1e-15 (relative to their largest
  value: the two frameworks' ``sin``/``exp`` may differ in the last bit);
  spacing, ``a_eff_per_iteration`` and ``spectral_bounds`` equal;
* cg, pipecg, mgcg, pipemgcg and pt to ``tol=1e-8``: iteration counts
  EQUAL (54, 55, 12, 13, 167), residual histories within rtol 1e-6 (or a
  tenth of tol, see ``_poisson_ref``), solutions within 1e-10 of the
  reference (relative to its largest value) and within the repo's oracle
  criterion (``_poisson_ref.check_solve``);
* f32 solves with ``dtype=`` (f32 fields, f64 scalars) to ``tol=1e-5``:
  cg 37 and mgcg 8 iterations, as the reference (histories rtol 5e-2,
  solutions 1e-5: the frameworks round f32 differently);
* a cg solve from a seeded start iterate carried in with ``convert``
  (73 iterations: its solution is held to 1e-9 of the reference's, as the
  rounding differences of the last iterations have more room to grow);
* ``overlap=True`` runs the overlapped operator (held against the
  reference in ``tests/test_torch_hide_apply.py``); ``mg`` refuses it, as
  the reference does.

The reference runs once, in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npy`` files.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _poisson_ref import check_solve, reference_solves  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402
from repro_torch.convert import fields_from_reference  # noqa: E402
from repro_torch.solvers import interior_mask  # noqa: E402
from repro_torch.telemetry import SolveStatus  # noqa: E402

TOL = 1e-8
# name: (periodic, method, tol, solver kwargs)
CASES = {
    "cg": (False, "cg", TOL, {}),
    "pipecg": (False, "pipecg", TOL, {}),
    "mgcg": (False, "mgcg", TOL, {}),
    "pipemgcg": (False, "pipemgcg", TOL, {}),
    "pt": (False, "pt", TOL, {}),
    "cg_f32": (False, "cg", 1e-5, {"dtype": "float32"}),
    "mgcg_f32": (False, "mgcg", 1e-5, {"dtype": "float32"}),
    "cg_x0": (False, "cg", TOL, {"x0": True}),
}
ITERATIONS = {"cg": 54, "pipecg": 55, "mgcg": 12, "pipemgcg": 13, "pt": 167, "cg_f32": 37,
              "mgcg_f32": 8}


def _x0():
    """A seeded start iterate, zero on the Dirichlet ring (the boundary
    condition of the oracle)."""
    g = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu").grid
    x0 = np.random.RandomState(7).rand(*g.stacked_shape) * 1e-3
    return g.to_stacked(g.from_stacked(x0) * interior_mask(g))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_poisson")
    return tmp, reference_solves(tmp, CASES, x0=_x0())


@pytest.fixture(scope="module")
def app():
    return Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")


def test_fields_and_constants_equal_reference(reference, app):
    tmp, meta = reference
    for name, t in (("c", app.c), ("b", app.b)):
        want = np.load(tmp / f"{name}_False.npy")
        np.testing.assert_allclose(app.grid.to_stacked(t), want, rtol=0,
                                   atol=1e-15 * np.abs(want).max(), err_msg=name)
    ref = meta["app_False"]
    assert list(app.spacing) == ref["spacing"]
    assert app.a_eff_per_iteration() == ref["a_eff"]
    np.testing.assert_allclose(app.spectral_bounds(), ref["bounds"], rtol=1e-15)


@pytest.mark.parametrize("name", [n for n in CASES if n != "cg_x0"])
def test_solve_vs_reference_and_oracle(reference, app, name):
    tmp, meta = reference
    _, method, tol, kw = CASES[name]
    kw = {k: getattr(torch, v) if k == "dtype" else v for k, v in kw.items()}
    u, info = app.solve(method, tol=tol, **kw)
    assert info.iterations == ITERATIONS[name]
    assert u.dtype == kw.get("dtype", torch.float64) and u.shape == app.grid.shape
    check_solve(app, u, info, tmp, meta, name, tol, f32="dtype" in kw)
    np.testing.assert_allclose(app.residual_norm(u), meta[name]["residual_norm"], rtol=1e-6,
                               atol=0.1 * tol)
    # no telemetry session: nothing is counted; the status is classified always
    assert info.wall_s > 0 and info.comm is None and info.status == SolveStatus.CONVERGED
    assert info.replacements == (-(-info.iterations // 50) if "pipe" in name else 0)


def test_solve_from_a_start_iterate(reference, app):
    tmp, meta = reference
    x0 = fields_from_reference(app.grid, _x0())
    x0_before = x0.clone()
    u, info = app.solve("cg", tol=TOL, x0=x0)
    assert torch.equal(x0, x0_before)   # the caller's start iterate is not touched
    check_solve(app, u, info, tmp, meta, "cg_x0", TOL, sol_tol=1e-9)


def test_overlap_and_unknown_methods_raise(app):
    with pytest.raises(ValueError, match="overlap"):
        app.solve("mg", overlap=True)
    with pytest.raises(ValueError, match="unknown method"):
        app.solve("sor")
    with pytest.raises(ValueError, match="variant"):
        app.solve("cg", variant="chronopoulos")
