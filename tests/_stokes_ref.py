"""Shared by ``test_torch_stokes*.py``: run the JAX package's ``Stokes3D``
velocity solves in a child process and hold the port's against them.

``reference_velocity_solves(tmp, solves)`` builds the reference's
``Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2))`` (14^3 global, f64; 8 fake CPU
devices), saves its viscosity and forcing as stacked arrays and solves each
case ``name: (stress, bc, precond, variant)`` at ``tol=1e-8``;
``port_app`` builds the port's app on those fields (``repro_torch.convert``)
and ``check_velocity_solve`` holds one port solve to the reference's:

* iteration count EQUAL;
* residual history within rtol 1e-6 or atol ``0.1 * tol`` (the rules of
  ``tests/_poisson_ref.py``: the last CG iterations are not reproducible
  to more than that, even within the reference);
* every component within 1e-10 of the reference's largest value.
"""

from __future__ import annotations

import json

import numpy as np

from _mp import run
from repro_torch import convert
from repro_torch.apps import Stokes3D

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
COMPS = ("vx", "vy", "vz")
FACES = ("xface", "yface", "zface")
TOL = 1e-8

_SNIPPET = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.apps.stokes import Stokes3D

TMP = {tmp!r}
apps = {{}}
def app_for(stress, bc):
    if (stress, bc) not in apps:
        apps[stress, bc] = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), stress=stress, bc=bc)
    return apps[stress, bc]

base = app_for("full", "noslip")
np.save(TMP + "/eta.npy", np.asarray(base.eta.data))
for k in ("vx", "vy", "vz"):
    np.save(f"{{TMP}}/F_{{k}}.npy", np.asarray(base.F[k].data))
meta = dict(spacing=list(base.spacing), a_eff=base.a_eff_per_iteration())
for name, (stress, bc, precond, variant) in {solves!r}.items():
    V, info = app_for(stress, bc).velocity_solve(precond=precond, tol={tol!r}, variant=variant)
    for k in ("vx", "vy", "vz"):
        np.save(f"{{TMP}}/V_{{name}}_{{k}}.npy", np.asarray(V[k].data))
    meta[name] = dict(iterations=info.iterations, residuals=np.asarray(info.residuals).tolist())
{extra}
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


def reference_velocity_solves(tmp, solves: dict, extra: str = "") -> dict:
    """Run every velocity solve of ``solves`` in the reference (and the
    snippet ``extra``, which sees ``app_for``, ``base`` and ``TMP``);
    returns the metadata (arrays stay in ``tmp``)."""
    run(_SNIPPET.format(tmp=str(tmp), solves=solves, tol=TOL, extra=extra), ndev=8, timeout=900)
    return json.loads((tmp / "meta.json").read_text())


def port_app(tmp, stress="full", bc="noslip"):
    """The port's app on the CPU with the reference's viscosity and forcing."""
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), stress=stress, bc=bc, device="cpu")
    g = app.grid
    app.eta = convert.field_from_reference(g, np.load(tmp / "eta.npy"), "center")
    app.F = convert.fieldset_from_reference(
        g, **{k: (np.load(tmp / f"F_{k}.npy"), loc) for k, loc in zip(COMPS, FACES)})
    return app


def check_velocity_solve(tmp, meta, name, solve, hist_atol=0.1 * TOL):
    """Run one port velocity solve ``(stress, bc, precond, variant)`` and hold
    it to the reference's (``hist_atol``: the history's absolute slack)."""
    stress, bc, precond, variant = solve
    app = port_app(tmp, stress, bc)
    V, info = app.velocity_solve(precond=precond, tol=TOL, variant=variant)
    want = meta[name]
    assert info.iterations == want["iterations"], (name, info.iterations, want["iterations"])
    np.testing.assert_allclose(info.residuals, want["residuals"], rtol=1e-6, atol=hist_atol)
    assert info.converged and info.relres <= TOL
    g = app.grid
    refs = {k: np.load(tmp / f"V_{name}_{k}.npy") for k in COMPS}
    scale = max(np.abs(r).max() for r in refs.values())
    for k, loc in zip(COMPS, FACES):
        assert V[k].loc == loc
        err = np.abs(g.to_stacked(V[k].data) - refs[k]).max() / scale
        assert err <= 1e-10, (name, k, err)
