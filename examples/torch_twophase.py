"""Paper Fig. 3 solver on the PyTorch/CUDA port: nonlinear 3-D two-phase
flow (porosity waves).

Run:  PYTHONPATH=src python examples/torch_twophase.py [--nx 40] [--method mgcg]
      PYTHONPATH=src python examples/torch_twophase.py --method explicit --nt 150
      PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_twophase.py

The twin of ``examples/twophase.py``.  The implicit (multigrid-
preconditioned CG) pressure solve advances the same physics at 10x the
explicit stability-limit ``dt``, so the default ``mgcg`` run takes 10x
fewer steps to the same horizon.  On a CUDA card the implicit pressure
operator and its cycle run the port's shifted K2-K5 kernels.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_common, device_arg, dims_arg, process_group, say  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--nt", type=int, default=None,
                    help="steps (default: 150 explicit, 15 implicit — the "
                         "same simulated horizon)")
    ap.add_argument("--method", default="mgcg", choices=["explicit", "cg", "mgcg"])
    ap.add_argument("--overlap", action="store_true",
                    help="hide_apply overlap on the implicit operator")
    ap.add_argument("--periodic", action="store_true",
                    help="periodic x/y dims (works with every method)")
    ap.add_argument("--heartbeat", type=int, default=0, metavar="K",
                    help="heartbeat event every K solver iterations "
                         "(installs the solve-health watchdogs)")
    ap.add_argument("--flight-record", metavar="DIR", default=None,
                    help="per-rank flight recorder dumping to DIR on failure "
                         "(diagnose with python -m repro_torch.telemetry.diag DIR)")
    add_common(ap)
    args = ap.parse_args(argv)

    from repro_torch import fields
    from repro_torch.apps import TwoPhase3D

    with process_group(args.backend) as world:
        per = (True, True, False) if args.periodic else (False, False, False)
        common = dict(nx=args.nx, ny=args.nx, nz=args.nx, periodic=per,
                      heartbeat=args.heartbeat, flight_dir=args.flight_record,
                      use_kernel=args.kernel, device=device_arg(args), dims=dims_arg(args))
        if args.method == "explicit":
            app = TwoPhase3D(hide=(8, 2, 2), **common)
        else:
            # dt defaults to 10x the explicit stability limit
            app = TwoPhase3D(method=args.method, overlap=args.overlap, tol=1e-6, **common)
        nt = args.nt if args.nt is not None else (150 if args.method == "explicit" else 15)
        g = app.grid
        say(f"processes: {world}, device: {g.device}")
        say(f"global grid {g.global_shape} over dims {g.dims}; "
            f"method={args.method} dt={app.dt:.3e} "
            f"({app.dt / app.dt_limit:.0f}x the explicit limit), {nt} steps")
        S = app.init_fields()
        phi0 = fields.gather(S.phi)
        S, infos = app.run(nt, S)
        P = fields.gather(S.Pe)
        F = fields.gather(S.phi)
        iters = [i.iterations for i in infos]
        if infos:
            say(f"implicit pressure solves: {sum(iters)} CG iterations total "
                f"({min(iters)}-{max(iters)}/step), all converged: "
                f"{all(i.converged for i in infos)}")
        # the porosity wave migrates upward: the center of mass of the anomaly rises
        z = np.arange(F.shape[2])
        anom0 = phi0 - phi0.min()
        anom1 = F - F.min()
        z0 = (anom0.sum((0, 1)) * z).sum() / anom0.sum()
        z1 = (anom1.sum((0, 1)) * z).sum() / anom1.sum()
        say(f"porosity anomaly z-center: {z0:.2f} -> {z1:.2f} "
            f"(wave {'rose' if z1 > z0 else 'did not rise'})")
        say(f"|Pe|_max = {np.abs(P).max():.4f}, phi in [{F.min():.4f}, {F.max():.4f}]")
        assert np.isfinite(P).all() and np.isfinite(F).all()
        assert all(i.converged for i in infos) and z1 > z0
        g.finalize()
        say("OK")
    return {"iters": iters, "z": (float(z0), float(z1)), "pe_max": float(np.abs(P).max()),
            "phi": (float(F.min()), float(F.max()))}


if __name__ == "__main__":
    main()
