"""Paper ref [4] on the PyTorch/CUDA port: Gross-Pitaevskii quantum fluid on
the implicit global grid.

Run:  PYTHONPATH=src python examples/torch_gross_pitaevskii.py [--nx 32] [--nt 200]
      PYTHONPATH=src python examples/torch_gross_pitaevskii.py --device cpu
      PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_gross_pitaevskii.py

The twin of ``examples/gross_pitaevskii.py``: RK4 on a complex64 field,
with a halo update of the complex blocks after every stage.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_common, device_arg, dims_arg, process_group, say  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=200)
    add_common(ap)
    args = ap.parse_args(argv)

    from repro_torch.apps import GrossPitaevskii3D

    with process_group(args.backend) as world:
        app = GrossPitaevskii3D(nx=args.nx, ny=args.nx, nz=args.nx, device=device_arg(args),
                                dims=dims_arg(args))
        say(f"processes: {world}, device: {app.grid.device}")
        psi = app.init_fields()
        n0 = app.norm(psi)
        psi = app.run(args.nt, psi)
        n1 = app.norm(psi)
        say(f"norm: {n0:.6f} -> {n1:.6f} (drift {(n1 - n0) / n0 * 100:+.3f}%)")
        G = app.grid.gather(psi)
        say(f"|psi|_max = {np.abs(G).max():.4f} (complex halo exchange works)")
        assert abs(n1 - n0) / n0 < 0.1
        app.grid.finalize()
        say("OK")
    return {"norm": (n0, n1), "psi_max": float(np.abs(G).max())}


if __name__ == "__main__":
    main()
