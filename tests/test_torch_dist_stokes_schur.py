"""Stokes3D's Schur-complement solves (the compiled schedule, ``"stress"``
and ``"face"`` preconditioned) over 2 gloo processes of 4 blocks each,
against the port in one process (a group of one process), all four runs
at once: ``Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))`` f64,
``solve(tol=1e-6, method="schur")`` takes the reference's counts in every
process (``"stress"`` 10 outer / 84 inner, ``"face"`` 10 / 193), and the
fields and the divergence residual agree within F5's tolerance
(``tests/test_torch_dist_stokes.py``).
"""

from __future__ import annotations

import pytest

from test_torch_dist_stokes import check_outer, run_parallel

NAMES = ("schur_stress", "schur_face")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist_stokes_schur")
    return run_parallel(tmp, {(name, P): (P, "test_torch_dist_stokes:outer_solves", (name,))
                              for name in NAMES for P in (2, 1)})


@pytest.mark.parametrize("name", NAMES)
def test_schur_solve_on_2_processes(runs, name):
    check_outer(runs[(name, 2)], runs[(name, 1)][0], name)
