"""The port's Uzawa Stokes solve against the JAX package, and the free-slip
Schur solve against the oracle.

* ``Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2)).solve(tol=1e-6,
  method="uzawa")`` from the reference's viscosity and forcing: outer,
  total inner and first inner counts EQUAL to the reference's (52 outer:
  the reference's own test requires Schur-CG to take at most a third of
  them), pressure and velocity within 1e-8 of the reference's largest
  values;
* Uzawa cut to ``chip_smoke.UZAWA_CUT`` outer iterations (the card runs that
  cut): the port's counts and divergence ratio equal the reference's, and
  so do the constants ``chip_smoke.py`` holds the card to;
* free slip: ``solve(tol=1e-7, method="schur")`` agrees with the
  independent NumPy oracle to 1e-4 (the reference's
  ``tests/test_stokes_full.py::test_freeslip_schur_matches_oracle``), with
  the tangential ghost ring filled by ``core.boundary.neumann0``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from _mp import run  # noqa: E402
from repro_torch import convert, fields  # noqa: E402
from repro_torch.apps import Stokes3D  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
COMPS = ("vx", "vy", "vz")
FACES = ("xface", "yface", "zface")

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.apps.stokes import Stokes3D

TMP = {tmp!r}
app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))
np.save(TMP + "/eta.npy", np.asarray(app.eta.data))
for k in ("vx", "vy", "vz"):
    np.save(f"{{TMP}}/F_{{k}}.npy", np.asarray(app.F[k].data))
V, P, info = app.solve(tol=1e-6, method="uzawa")
np.save(TMP + "/P.npy", np.asarray(P.data))
for k in ("vx", "vy", "vz"):
    np.save(f"{{TMP}}/V_{{k}}.npy", np.asarray(V[k].data))
_, _, cut = app.solve(tol=1e-6, method="uzawa", outer_maxiter={cut})
json.dump(dict(outer=info.outer_iterations, inner=info.inner_iterations,
               first=info.first_inner_iterations, converged=info.converged),
          open(TMP + "/meta.json", "w"))
json.dump(dict(outer=cut.outer_iterations, inner=cut.inner_iterations,
               first=cut.first_inner_iterations, relres_div=float(cut.relres_div)),
          open(TMP + "/cut.json", "w"))
print("OK")
"""


def _chip_smoke():
    """``chip_smoke.py``'s constants (the module defines, it runs nothing on
    import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stokes_uzawa")
    run(REFERENCE.format(tmp=str(tmp), cut=CHIP.UZAWA_CUT), ndev=8, timeout=900)
    return tmp, json.loads((tmp / "meta.json").read_text())


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_uzawa_equals_reference(reference):
    tmp, want = reference
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu")
    g = app.grid
    app.eta = convert.field_from_reference(g, np.load(tmp / "eta.npy"), "center")
    app.F = convert.fieldset_from_reference(
        g, **{k: (np.load(tmp / f"F_{k}.npy"), loc) for k, loc in zip(COMPS, FACES)})
    V, P, info = app.solve(tol=1e-6, method="uzawa")
    got = dict(outer=info.outer_iterations, inner=info.inner_iterations,
               first=info.first_inner_iterations, converged=info.converged)
    assert got == want, (got, want)
    inner = (slice(1, -1),) * 3
    assert _rel(g.gather(P.data)[inner], g.gather(g.from_stacked(np.load(tmp / "P.npy")))[inner]) \
        < 1e-8
    for k, loc in zip(COMPS, FACES):
        ref = convert.field_from_reference(g, np.load(tmp / f"V_{k}.npy"), loc)
        assert _rel(fields.gather(V[k]), fields.gather(ref)) < 1e-8, k


def test_uzawa_cut_equals_reference(reference):
    """``chip_smoke.py`` runs Uzawa's first ``UZAWA_CUT`` outer iterations
    on the card and holds them to the counts and ``||div V|| / ||div V_1||``
    it states as the reference's: the port here, from its own viscosity and
    forcing, and those constants against the reference's run."""
    tmp, _ = reference
    want = json.loads((tmp / "cut.json").read_text())
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu")
    _, _, info = app.solve(tol=1e-6, method="uzawa", outer_maxiter=CHIP.UZAWA_CUT)
    got = (info.outer_iterations, info.inner_iterations, info.first_inner_iterations)
    assert got == (want["outer"], want["inner"], want["first"]) == \
        CHIP.STOKES_SOLVES["uzawa_cut"][1], (got, want)
    for value in (float(info.relres_div), CHIP.UZAWA_CUT_RELRES_DIV):
        assert abs(value / want["relres_div"] - 1) <= CHIP.RELRES_RTOL, (value, want)


def test_freeslip_schur_matches_oracle():
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), bc="freeslip", device="cpu")
    V, P, info = app.solve(tol=1e-7, method="schur")
    assert info.converged
    Vx, Vy, Vz, Po = app.oracle(tol=1e-9)
    ref = {"vx": Vx[:-1, :, :], "vy": Vy[:, :-1, :], "vz": Vz[:, :, :-1]}
    scale = max(np.abs(r).max() for r in ref.values())
    for k in COMPS:
        err = np.abs(fields.gather(V[k]) - ref[k]).max() / scale
        assert err < 1e-4, (k, err)
    inner = (slice(1, -1),) * 3
    assert _rel(app.grid.gather(P.data)[inner], Po[inner]) < 1e-4
    with pytest.raises(ValueError, match="unknown method"):
        app.solve(method="bicg")
