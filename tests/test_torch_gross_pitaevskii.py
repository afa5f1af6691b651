"""The port's ``GrossPitaevskii3D`` against the JAX package's, at 10^3
local cells on ``dims=(2, 2, 2)`` (18^3 global), complex64, 10 RK4 steps
(the case of ``tests/test_apps.py::test_gross_pitaevskii_norm_and_oracle``).

* ``dx`` and ``dt`` equal the reference's; the potential (float32) and the
  start field (complex64) equal the reference's gathered arrays to 1e-6 of
  their largest value (the reference evaluates them in float32, the port
  in float64 before the cast);
* the gathered field after 10 steps is within 1e-5 of the reference's and
  of the reference's oracle, and within 1e-5 of the port's own oracle (the
  single-block step on the gathered field);
* the norm drifts by less than 5 % (the reference's criterion), as the
  reference's does;
* the port's 8-block field equals its 1-block field bitwise; the ring of
  the physical boundary keeps its start values (the right-hand side is
  zero there).

The reference runs once, in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npy`` files.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch.apps import GrossPitaevskii3D  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
NT = 10
TOL = 1e-5

REFERENCE = ALIAS + """
import json
from repro.apps.gross_pitaevskii import GrossPitaevskii3D

TMP = {tmp!r}
app = GrossPitaevskii3D(nx=10, ny=10, nz=10, dims=(2, 2, 2))
g = app.grid
psi0 = app.init_fields()
n0 = app.norm(psi0)
psi = app.run({nt}, psi=psi0)
np.save(TMP + "/psi0.npy", g.gather(psi0))
np.save(TMP + "/V.npy", g.gather(app._V))
np.save(TMP + "/psi.npy", g.gather(psi))
np.save(TMP + "/oracle.npy", app.oracle({nt}))
print(json.dumps({{"dx": app.dx, "dt": app.dt, "n0": n0, "n1": app.norm(psi),
                  "dtype": str(g.gather(psi).dtype)}}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gp"))
    out = run(REFERENCE.format(tmp=tmp, nt=NT), ndev=8)
    return tmp, json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    app = GrossPitaevskii3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    psi0 = app.init_fields()
    n0 = app.norm(psi0)
    psi = app.run(NT, psi=psi0.clone())
    return app, psi0, n0, psi


def test_setup_matches_reference(reference, port):
    tmp, meta = reference
    app, psi0, _, _ = port
    assert app.dx == meta["dx"] and app.dt == meta["dt"]
    assert psi0.dtype == torch.complex64 and app._V.dtype == torch.float32
    for name, got in (("psi0", app.grid.gather(psi0)), ("V", app.grid.gather(app._V))):
        want = np.load(f"{tmp}/{name}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name


def test_run_matches_reference_and_oracles(reference, port):
    tmp, meta = reference
    app, _, n0, psi = port
    got = app.grid.gather(psi)
    assert got.dtype == np.complex64 and meta["dtype"] == "complex64"
    assert np.isfinite(got).all()
    assert np.abs(got - np.load(f"{tmp}/psi.npy")).max() < TOL
    assert np.abs(got - np.load(f"{tmp}/oracle.npy")).max() < TOL
    own = app.oracle(NT)
    assert np.abs(got - own).max() < TOL
    # the field moved: the checks above compare something
    assert np.abs(got - app.grid.gather(app.init_fields())).max() > 1e-3


def test_norm_drift(reference, port):
    _, meta = reference
    app, _, n0, psi = port
    n1 = app.norm(psi)
    assert abs(n1 - n0) / n0 < 0.05
    assert abs(meta["n1"] - meta["n0"]) / meta["n0"] < 0.05
    np.testing.assert_allclose([n0, n1], [meta["n0"], meta["n1"]], rtol=1e-5)


def test_blocks_bitwise_and_ring(port):
    app, _, _, psi = port
    one = GrossPitaevskii3D(nx=18, ny=18, nz=18, dims=(1, 1, 1), device="cpu")
    assert one.dx == app.dx and one.dt == app.dt
    np.testing.assert_array_equal(app.grid.gather(psi), one.grid.gather(one.run(NT)))
    G, G0 = app.grid.gather(psi), app.grid.gather(app.init_fields())
    for d in range(3):
        for end in (0, -1):
            # the right-hand side is zero on the ring: the ring keeps its start values
            np.testing.assert_array_equal(np.take(G, end, axis=d), np.take(G0, end, axis=d))
