"""Stokes3D's Uzawa solve over 2 gloo processes of 4 blocks each, against
the port in one process (a group of one process), both run at once:
``Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))`` f64, ``solve(tol=1e-6,
method="uzawa")`` takes the reference's 52 outer and 212 inner iterations
in every process, and the fields and the divergence residual agree within
F5's tolerance (``tests/test_torch_dist_stokes.py``).
"""

from __future__ import annotations

from test_torch_dist_stokes import check_outer, run_parallel


def test_uzawa_solve_on_2_processes(tmp_path):
    runs = run_parallel(tmp_path, {P: (P, "test_torch_dist_stokes:outer_solves", ("uzawa",))
                                   for P in (2, 1)})
    check_outer(runs[2], runs[1][0], "uzawa")
