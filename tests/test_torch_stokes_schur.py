"""The port's Schur-complement CG Stokes solve against the JAX package.

``Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))`` f64, ``solve(tol=1e-6,
method="schur")`` with the ``"face"`` and ``"stress"`` velocity
preconditioners, from the reference's viscosity and forcing:

* outer, total inner and first inner iteration counts EQUAL to the
  reference's (its ``compiled=False`` loop; the reference requires its
  compiled loop to give the same counts, ``tests/test_stokes_full.py``);
* the port's loop on the compiled schedule (``compiled=True``) and its host loop
  (``compiled=False``) give the same counts and pressures and velocities
  within 1e-10 of their largest values (the reference's criterion for its
  own two loops);
* pressure and velocity within 1e-8 of the reference's largest value (its
  1-vs-8-rank criterion), the recomputed momentum residual below 1e-4, and
  the solution within 1e-4 of ``Stokes3D.oracle(tol=1e-9)`` (the criterion
  of the reference's ``tests/test_apps.py``).

The reference runs once in a module-scoped child process with 8 fake CPU
devices; the port's four solves run once in a module-scoped fixture.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import convert, fields  # noqa: E402
from repro_torch.apps import Stokes3D  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
COMPS = ("vx", "vy", "vz")
FACES = ("xface", "yface", "zface")
PRECONDS = ("face", "stress")
TOL = 1e-6

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.apps.stokes import Stokes3D

TMP = {tmp!r}
app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))
np.save(TMP + "/eta.npy", np.asarray(app.eta.data))
for k in ("vx", "vy", "vz"):
    np.save(f"{{TMP}}/F_{{k}}.npy", np.asarray(app.F[k].data))
meta = {{}}
for precond in {preconds!r}:
    V, P, info = app.solve(tol={tol!r}, method="schur", compiled=False, precond=precond)
    np.save(f"{{TMP}}/P_{{precond}}.npy", np.asarray(P.data))
    for k in ("vx", "vy", "vz"):
        np.save(f"{{TMP}}/V_{{precond}}_{{k}}.npy", np.asarray(V[k].data))
    meta[precond] = dict(outer=info.outer_iterations, inner=info.inner_iterations,
                         first=info.first_inner_iterations, converged=info.converged)
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stokes_schur")
    run(REFERENCE.format(tmp=str(tmp), preconds=PRECONDS, tol=TOL), ndev=8, timeout=900)
    return tmp, json.loads((tmp / "meta.json").read_text())


@pytest.fixture(scope="module")
def port(reference):
    """The port's app on the reference's fields, and its four solves."""
    tmp, _ = reference
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu")
    g = app.grid
    app.eta = convert.field_from_reference(g, np.load(tmp / "eta.npy"), "center")
    app.F = convert.fieldset_from_reference(
        g, **{k: (np.load(tmp / f"F_{k}.npy"), loc) for k, loc in zip(COMPS, FACES)})
    solves = {(p, c): app.solve(tol=TOL, method="schur", compiled=c, precond=p)
              for p in PRECONDS for c in (False, True)}
    return app, solves


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("precond", PRECONDS)
def test_schur_equals_reference(reference, port, precond, compiled):
    tmp, meta = reference
    app, solves = port
    V, P, info = solves[precond, compiled]
    want = meta[precond]
    got = dict(outer=info.outer_iterations, inner=info.inner_iterations,
               first=info.first_inner_iterations, converged=info.converged)
    assert got == want, (precond, compiled, got, want)
    assert info.relres_div <= TOL and info.relres_momentum < 1e-4
    g = app.grid
    inner = (slice(1, -1),) * 3
    assert P.loc == "center"
    assert _rel(g.gather(P.data)[inner], g.gather(g.from_stacked(
        np.load(tmp / f"P_{precond}.npy")))[inner]) < 1e-8
    for k, loc in zip(COMPS, FACES):
        assert V[k].loc == loc
        ref = convert.field_from_reference(g, np.load(tmp / f"V_{precond}_{k}.npy"), loc)
        assert _rel(fields.gather(V[k]), fields.gather(ref)) < 1e-8, k


@pytest.mark.parametrize("precond", PRECONDS)
def test_compiled_loop_equals_host_loop(port, precond):
    app, solves = port
    Vp, Pp, ip = solves[precond, False]
    Vc, Pc, ic = solves[precond, True]
    assert (ic.outer_iterations, ic.inner_iterations, ic.first_inner_iterations) == \
        (ip.outer_iterations, ip.inner_iterations, ip.first_inner_iterations)
    g = app.grid
    inner = (slice(1, -1),) * 3
    assert _rel(g.gather(Pc.data)[inner], g.gather(Pp.data)[inner]) < 1e-10
    for k in COMPS:
        assert _rel(fields.gather(Vc[k]), fields.gather(Vp[k])) < 1e-10, k


def test_schur_solution_matches_oracle(port):
    app, solves = port
    V, P, info = solves["stress", True]
    Vx, Vy, Vz, Po = app.oracle(tol=1e-9)
    ref = {"vx": Vx[:-1, :, :], "vy": Vy[:, :-1, :], "vz": Vz[:, :, :-1]}
    scale = max(np.abs(r).max() for r in ref.values())
    for k in COMPS:
        err = np.abs(fields.gather(V[k]) - ref[k]).max() / scale
        assert err < 1e-4, (k, err)
    inner = (slice(1, -1),) * 3
    assert _rel(app.grid.gather(P.data)[inner], Po[inner]) < 1e-4
    rm, dn = app.residuals(V, P)
    assert rm == pytest.approx(info.relres_momentum, rel=1e-6) and np.isfinite(dn)
