"""3-D full-stress variable-viscosity Stokes on the staggered grid, on the
PyTorch/CUDA port.

Run:  PYTHONPATH=src python examples/torch_stokes.py
      PYTHONPATH=src python examples/torch_stokes.py --device cpu
      PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_stokes.py

The twin of ``examples/stokes.py``.  Velocities live on cell faces,
pressure and viscosity in cell centers; the momentum operator is the full
symmetric-gradient stress ``-div(2 eta D(V))``.  The velocity block is
solved by CG over the whole staggered FieldSet, preconditioned by the
coupled staggered multigrid cycle; the pressure by CG on the
viscosity-preconditioned Schur complement.  On a CUDA card the operators
run the port's face kernels (K2-K5 face) where a cycle applies them.

``--heartbeat K`` streams a health heartbeat every K solver iterations;
``--flight-record DIR`` arms the per-rank flight recorder (post-mortem via
``python -m repro_torch.telemetry.diag DIR``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_common, device_arg, dims_arg, process_group, say  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heartbeat", type=int, default=0, metavar="K",
                    help="heartbeat event every K solver iterations "
                         "(installs the solve-health watchdogs)")
    ap.add_argument("--flight-record", metavar="DIR", default=None,
                    help="per-rank flight recorder dumping to DIR on failure "
                         "(diagnose with python -m repro_torch.telemetry.diag DIR)")
    add_common(ap)
    args = ap.parse_args(argv)

    from repro_torch import fields
    from repro_torch.apps import Stokes3D

    with process_group(args.backend):
        # Local block 10^3 (incl. halo) per process: one process holds one
        # block, P processes under torchrun a grid of P blocks.
        app = Stokes3D(nx=10, ny=10, nz=10, eta_amp=0.5, use_kernel=args.kernel,
                       device=device_arg(args), dims=dims_arg(args),
                       heartbeat=args.heartbeat, flight_dir=args.flight_record)
        say(f"global grid {app.grid.global_shape}, {app.grid.dims} blocks")

        # the staggered velocity system as ONE Krylov vector: plain CG vs the
        # coupled staggered-MG preconditioner vs the center-cycle baseline
        _, plain = app.velocity_solve(precond=None, tol=1e-8)
        _, stag = app.velocity_solve(precond="stress", tol=1e-8)
        _, cent = app.velocity_solve(precond="center", tol=1e-8)
        say(f"velocity solve: plain CG {plain.iterations} iters, "
            f"staggered-MG CG {stag.iterations} iters, "
            f"center-cycle CG {cent.iterations} iters")

        # full Stokes: CG on the viscosity-preconditioned Schur complement
        V, P, info = app.solve(tol=1e-6, method="schur")
        say(f"stokes (schur-cg): {info.outer_iterations} outer / "
            f"{info.inner_iterations} inner iters, "
            f"div residual {info.relres_div:.1e}, "
            f"momentum residual {info.relres_momentum:.1e}")

        # staggered fields gather to their valid deduplicated global shape
        vx = fields.gather(V.vx)
        say(f"vx valid global shape {vx.shape}, max |vx| = {abs(vx).max():.3e}")
        assert all(i.converged for i in (plain, stag, cent)) and info.converged
        assert np.isfinite(vx).all()
        say("OK")
    return {"velocity": (plain.iterations, stag.iterations, cent.iterations),
            "schur": (info.outer_iterations, info.inner_iterations),
            "relres_div": info.relres_div, "vx_max": float(abs(vx).max()),
            "vx_shape": tuple(vx.shape)}


if __name__ == "__main__":
    main()
