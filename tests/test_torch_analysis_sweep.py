"""The port's analyzer sweep against the JAX package's, target by target.

The reference's app matrix (``repro.analysis.driver.sweep``: Poisson /
Heat / TwoPhase / Stokes over periodic x overlap x ``use_kernel``) runs in
two child processes with 8 fake devices each (the aliases of
``tests/_torch_analysis.py``), while the port's matrix runs here on 2x2x2
blocks.  On each of the 18 targets the reference can run, the port's set
of (rule, severity) must equal the reference's (both empty: the apps are
clean).  The reference's two ``interpret`` targets and ``kernels/library``
fail on jax 0.9 (ROADMAP F13); their port counterparts — the CUDA route
(launch plans recorded, nothing launched) and every kernel's launch plan —
are held to the documented contract: clean.  A whole sweep leaves every
kernel's launch count as it was.  The ``group/`` targets are in
``tests/test_torch_analysis_group.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from _mp import PRELUDE, SRC
from _torch_analysis import REFERENCE_PRELUDE, rule_set
from repro_torch.analysis import driver

PORT_ONLY = ("poisson/mgcg[dirichlet,cuda]", "heat/step[hide,cuda]", "kernels/library")
RUNNABLE = tuple(n for n in driver.targets() if n not in PORT_ONLY and not n.startswith("group/"))
SNIPPET = REFERENCE_PRELUDE + """
from repro.analysis.driver import sweep
reports = sweep(targets={names!r})
print("RESULT " + json.dumps({{k: sorted({{(f.rule, f.severity) for f in r}})
                              for k, r in reports.items()}}))
"""


def _start(names):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = PRELUDE.format(ndev=8) + textwrap.dedent(SNIPPET.format(names=list(names)))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def sweeps():
    # the Stokes targets are the slow half of the reference's sweep
    halves = ([n for n in RUNNABLE if n.startswith("stokes")],
              [n for n in RUNNABLE if not n.startswith("stokes")])
    procs = [_start(h) for h in halves]
    try:
        from repro_torch.kernels.solver3d import kernel as sk
        from repro_torch.kernels.stencil3d import kernel as hk
        before = [w.launches for w in sk.WRAPPERS] + [hk.heat_step_cuda.launches]
        port = {n: driver.run_target(n) for n in RUNNABLE + PORT_ONLY}
        after = [w.launches for w in sk.WRAPPERS] + [hk.heat_step_cuda.launches]
        ref = {}
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-6000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
            ref.update({k: [tuple(x) for x in v] for k, v in json.loads(line[7:]).items()})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return port, ref, before, after


@pytest.mark.parametrize("name", RUNNABLE)
def test_target_matches_reference(sweeps, name):
    port, ref, _, _ = sweeps
    assert rule_set(port[name]) == ref[name], [str(f) for f in port[name]]
    assert ref[name] == []


@pytest.mark.parametrize("name", PORT_ONLY)
def test_port_only_target_clean(sweeps, name):
    port = sweeps[0]
    assert not port[name], [str(f) for f in port[name]]


def test_sweep_launches_nothing(sweeps):
    _, _, before, after = sweeps
    assert before == after
