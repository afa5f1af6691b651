"""Helpers of the port's analyzer tests (``tests/test_torch_analysis*.py``).

``analyze_clean`` is the port's counterpart of the JAX package's fixture of
the same name: it runs a callable (or, with ``capture=True``, an app solve
through the solvers' capture hooks) under :mod:`repro_torch.analysis` and
fails the test on any error-severity finding.  Nothing reaches a device.
Test modules import it (``from _torch_analysis import analyze_clean``).

``REFERENCE_PRELUDE`` starts a child snippet that drives the JAX package's
analyzer (``tests/_mp.py::run``): on jax 0.9 it needs five aliases of
moved names and x64 (ROADMAP F13).  Never set them in the pytest process.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

REFERENCE_PRELUDE = """
import jax.extend.core, jax._src.core
for _n in ("Primitive", "ClosedJaxpr", "Jaxpr", "Literal"):
    setattr(jax.core, _n, getattr(jax.extend.core, _n))
jax.core.eval_jaxpr = jax._src.core.eval_jaxpr
jax.config.update("jax_enable_x64", True)
import json
"""


def rule_set(rep) -> list:
    """Sorted (rule, severity) pairs of a report."""
    return sorted({(f.rule, f.severity) for f in rep})


@pytest.fixture
def analyze_clean():
    from repro_torch import analysis

    def _check(fn, *args, halo: int = 1, capture: bool = False):
        if capture:
            rep = analysis.capture_check(fn, *args)
        else:
            rep = analysis.check(fn, *args, halo=halo)
        errs = rep.errors()
        assert not errs, "static analysis found errors:\n" + "\n".join(f"  {f}" for f in errs)
        return rep

    return _check
