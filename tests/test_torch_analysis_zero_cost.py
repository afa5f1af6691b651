"""Zero cost: the analyzer changes nothing it does not check.

The port's counterpart of the JAX package's
``test_lowered_hlo_identical_after_analysis``.  In one fresh process a
Poisson3D mgcg solve (8 blocks of 10^3, f64, tol 1e-8) and a Heat3D step
with ``hide_communication`` (8 blocks of 16^3) run three times: before the
analyzer's rules are imported (the layers import only its markers), after
they are imported, and after a sweep has checked the same two apps.  Each
time, under a counting dispatch mode, the iterate and the stepped field
are bitwise the same, the number of tensor ops and of host reads is the
same, and no kernel launch count moves.  On the card ``chip_smoke.py``'s
``analysis`` phase holds the same with the kernels launched.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from _mp import SRC

SNIPPET = """
import hashlib, json, sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.apps import Heat3D, Poisson3D
from repro_torch.kernels.solver3d import kernel as sk
from repro_torch.kernels.stencil3d import kernel as hk

class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = self.reads = 0
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))

def sha(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()

def launches():
    return [w.launches for w in sk.WRAPPERS] + [hk.heat_step_cuda.launches]

def run():
    p = Poisson3D(dims=(2, 2, 2), device="cpu")
    h = Heat3D(nx=16, ny=16, nz=16, hide=(8, 2, 2), dims=(2, 2, 2), device="cpu")
    T, Ci = h.init_fields()
    l0 = launches()
    with Count() as c:
        u, info = p.solve("mgcg", tol=1e-8)
        T2 = h._step(T, Ci)
    return dict(u=sha(u), T=sha(T2), iterations=info.iterations, ops=c.ops, reads=c.reads,
                launches=[b - a for a, b in zip(l0, launches())])

runs = {"before": run()}
assert "repro_torch.analysis.trace" not in sys.modules
assert "repro_torch.analysis.driver" not in sys.modules
from repro_torch.analysis import driver
runs["imported"] = run()
reports = driver.sweep(["poisson/mgcg[dirichlet]", "heat/step[hide]"])
assert len(reports) == 2 and not driver.merged(reports), [str(f) for r in reports.values() for f in r]
runs["after_check"] = run()
print("RESULT " + json.dumps(runs))
"""


def test_solve_and_step_identical_with_and_after_the_analyzer():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SNIPPET)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-6000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    runs = json.loads(line[7:])
    first = runs["before"]
    assert first["iterations"] == 12 and first["reads"] > 0 and first["ops"] > 0
    assert not any(first["launches"])
    for name, r in runs.items():
        assert r == first, (name, r, first)
