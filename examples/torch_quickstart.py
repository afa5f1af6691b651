"""Paper Fig. 1 on the PyTorch/CUDA port: 3-D heat diffusion with 3 grid calls.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--nx 48] [--nt 100]
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
      PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_quickstart.py

The twin of ``examples/quickstart.py``.  The solver is single-block code on
the LOCAL grid; ``init_global_grid``, ``update_halo``/``hide_communication``
and ``finalize`` make it distributed — the paper's 3-function recipe.
Under ``torchrun`` each process joins a ``torch.distributed`` group (gloo
by default, so that several processes may share one card; ``--backend
nccl`` with one card per process) and holds one block of the global grid.
The heat step is the port's kernel K1 on a CUDA card (``--kernel auto``),
its plain PyTorch version on the CPU or with ``--kernel ref``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_common, device_arg, dims_arg, process_group, say  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--no-hide", action="store_true")
    ap.add_argument("--bump", action="store_true",
                    help="start from 1.7 plus a Gaussian bump (the default start, the "
                         "constant 1.7 of examples/quickstart.py, stays constant)")
    add_common(ap)
    args = ap.parse_args(argv)

    from repro_torch.apps import Heat3D

    with process_group(args.backend) as world:
        app = Heat3D(nx=args.nx, ny=args.nx, nz=args.nx,
                     hide=None if args.no_hide else (16, 2, 2), use_kernel=args.kernel,
                     device=device_arg(args), dims=dims_arg(args))
        g = app.grid
        say(f"processes: {world}, device: {g.device}")
        say(f"implicit global grid: {g.global_shape} over dims {g.dims} "
            f"(local {g.local_shape}, overlap {g.overlap})")

        T, Ci = app.init_fields()
        if args.bump:
            def bump(ix, iy, iz):
                x, y, z = ix.double() * app.dx, iy.double() * app.dy, iz.double() * app.dz
                r2 = (x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2
                return 1.7 + (-r2 / 0.02).exp()
            T = g.from_global_fn(bump)
        start = g.gather(T), g.gather(Ci)
        T, _ = app.run(args.nt, T, Ci)
        G = g.gather(T)
        center = float(G[tuple(s // 2 for s in G.shape)])
        say(f"after {args.nt} steps: T[center] = {center:.6f}, mean = {G.mean():.6f}")
        out = {"center": center, "mean": float(G.mean()), "field": G}

        if args.nx <= 48:
            ref = app.oracle(args.nt, *start)
            err = float(np.abs(G - ref).max())
            say(f"max |distributed - single-array oracle| = {err:.3e}")
            assert err < 1e-4
            out["oracle_err"] = err
        g.finalize()
        say("OK")
    return out


if __name__ == "__main__":
    main()
