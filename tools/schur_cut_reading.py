"""Read what the first outer iterations of the 1 x 386^3 Schur-CG solve give
on the card: the constants ``SCHUR_CUT_*`` of ``chip_smoke.py`` hold its
``stokes_full`` phase to them.

Runs the phase's sequence on one rank (the "face" and "stress" velocity
solves, then Schur-CG with the face preconditioner, tol 1e-6) with the solve
cut to 4, 4 again (the reading repeats bitwise) and 3 outer iterations, and
prints each cut's counts and residuals as JSON.  Run from the repository's
root on a machine with a CUDA card: ``python3 tools/schur_cut_reading.py``
(about 100 s with the kernels' build)."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402


def main() -> None:
    from repro_torch import fields
    from repro_torch.apps import Stokes3D
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load()
    app = Stokes3D(nx=386, ny=386, nz=386, dims=(1, 1, 1))
    fields.zeros(app.grid, "center")
    for precond in ("face", "stress"):
        _, info = app.velocity_solve(precond=precond, tol=1e-8)
        print("velocity", precond, info.iterations, flush=True)
    for k in (4, 4, 3):
        t0 = time.perf_counter()
        V, P, info = app.solve(tol=1e-6, method="schur", precond="face", outer_maxiter=k)
        seconds = time.perf_counter() - t0
        rm, dn = app.residuals(V, P)
        print(json.dumps({"outer_maxiter": k, "outer": info.outer_iterations,
                          "inner": info.inner_iterations, "relres_div": info.relres_div,
                          "relres_momentum": info.relres_momentum, "recomputed": rm,
                          "div": dn, "converged": info.converged, "s": seconds}), flush=True)
        del V, P


if __name__ == "__main__":
    main()
