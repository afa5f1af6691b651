"""The port's ``Poisson3D`` (standalone multigrid, and every method on the
all-periodic problem) against the JAX package's, on
``Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2))`` in f64.

* Dirichlet ``mg`` with Jacobi and with Chebyshev smoothing to
  ``tol=1e-8``: 20 and 18 V-cycles, as the reference;
* all-periodic (singular, nullspace-projected) cg, mgcg, pipecg and mg:
  26, 10, 27 and 17 iterations, as the reference; the mean-zero
  representative comes back; ``pt`` is rejected;
* iteration counts EQUAL, residual histories within rtol 1e-6 (or a tenth
  of tol, see ``_poisson_ref``), solutions
  within 1e-10 of the reference (relative to its largest value) and within
  the repo's oracle criterion (``_poisson_ref.check_solve``); ``c`` and
  ``b`` of the periodic problem equal the reference's to 1e-15 relative.

The reference runs once, in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npy`` files.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _poisson_ref import check_solve, reference_solves  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402

TOL = 1e-8
CASES = {
    "mg": (False, "mg", TOL, {}),
    "mg_chebyshev": (False, "mg", TOL, {"smoother": "chebyshev"}),
    "periodic_cg": (True, "cg", TOL, {}),
    "periodic_mgcg": (True, "mgcg", TOL, {}),
    "periodic_pipecg": (True, "pipecg", TOL, {}),
    "periodic_mg": (True, "mg", TOL, {}),
}
ITERATIONS = {"mg": 20, "mg_chebyshev": 18, "periodic_cg": 26, "periodic_mgcg": 10,
              "periodic_pipecg": 27, "periodic_mg": 17}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_poisson_mg")
    return tmp, reference_solves(tmp, CASES)


@pytest.fixture(scope="module")
def apps():
    return {per: Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=(per,) * 3,
                           device="cpu") for per in (False, True)}


@pytest.mark.parametrize("name", list(CASES))
def test_solve_vs_reference_and_oracle(reference, apps, name):
    tmp, meta = reference
    per, method, tol, kw = CASES[name]
    app = apps[per]
    u, info = app.solve(method, tol=tol, **kw)
    assert info.iterations == ITERATIONS[name]
    check_solve(app, u, info, tmp, meta, name, tol)
    if per:
        inner = app.grid.gather(u)[1:-1, 1:-1, 1:-1]
        assert abs(inner.mean()) < 1e-12 * np.abs(inner).max()


def test_periodic_fields_equal_reference_and_pt_is_rejected(reference, apps):
    tmp, meta = reference
    app = apps[True]
    assert app.singular
    for name, t in (("c", app.c), ("b", app.b)):
        want = np.load(tmp / f"{name}_True.npy")
        np.testing.assert_allclose(app.grid.to_stacked(t), want, rtol=0,
                                   atol=1e-15 * np.abs(want).max(), err_msg=name)
    assert list(app.spacing) == meta["app_True"]["spacing"]
    with pytest.raises(ValueError, match="singular"):
        app.solve("pt")


@pytest.mark.cuda
@pytest.mark.parametrize("per", [False, True])
def test_kernels_reproduce_the_counts_on_card(per):
    """On the card (kernels K2-K5) every method takes the reference's
    iterations, and its solution equals the plain path's to 1e-10."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts = ({"cg": 26, "mgcg": 10, "pipecg": 27, "mg": 17} if per else
              {"cg": 54, "pipecg": 55, "mgcg": 12, "pipemgcg": 13, "pt": 167, "mg": 20})
    apps = {uk: Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=(per,) * 3,
                          use_kernel=uk) for uk in ("auto", "ref")}
    for method, want in counts.items():
        (u, info), (v, _) = (a.solve(method, tol=TOL) for a in apps.values())
        assert info.iterations == want, method
        assert (u - v).abs().max().item() <= 1e-10 * v.abs().max().item(), method
