"""Shared by ``test_torch_poisson*.py``: run the JAX package's ``Poisson3D``
solves in a child process and hold the port's against them.

``reference_solves(tmp, cases)`` solves each case with the reference
(8 fake CPU devices, f64, ``dims=(2, 2, 2)``, local 10^3) and saves the
stacked solution, iteration count, residual history and relative residual;
``check_solve`` compares one port solve with it:

* iteration count EQUAL;
* residual history within rtol 1e-6 or atol ``0.1 * tol`` (relative
  residuals: a difference below a tenth of the stopping tolerance cannot
  move the stopping test).  The atol is for the last CG iterations, where
  rounding differences grow about tenfold per iteration: the reference's
  own cg history differs between 1 and 8 ranks by 17 % at its last
  iteration (54) and pipecg's by 1.2 %.  f32 solves: rtol 5e-2 — the two
  frameworks round each f32 field operation differently and CG amplifies
  it (2.3 % measured at cg iteration 34);
* solution within 1e-10 of the reference, relative to its largest value
  (f32: 1e-5);
* f64: within the repo's oracle criterion of ``oracle(tol=1e-12)``:
  relative error < 1e-4 and ``residual_norm`` < 2 tol (the reference's
  ``tests/test_solvers.py``).  An f32 solve to ``tol=1e-5`` is ~14 % from
  the oracle, as the reference's own f32 solve is: it is held to the
  reference's solution instead.
"""

from __future__ import annotations

import json

import numpy as np

from _mp import run

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

_SNIPPET = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.apps.poisson import Poisson3D

TMP = {tmp!r}
meta = {{}}
apps = {{}}
for name, (per, method, tol, kw) in {cases!r}.items():
    if per not in apps:
        app = apps[per] = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=(per,) * 3)
        np.save(f"{{TMP}}/c_{{per}}.npy", np.asarray(app.c))
        np.save(f"{{TMP}}/b_{{per}}.npy", np.asarray(app.b))
        np.save(f"{{TMP}}/oracle_{{per}}.npy", app.oracle(tol=1e-12))
        meta[f"app_{{per}}"] = dict(
            spacing=list(app.spacing), a_eff=app.a_eff_per_iteration(),
            bounds=None if per else list(app.spectral_bounds()))
    app = apps[per]
    kw = dict(kw)
    if kw.pop("x0", False):
        kw["x0"] = jnp.asarray(np.load(f"{{TMP}}/x0.npy"))
    if kw.get("dtype") == "float32":
        kw["dtype"] = jnp.float32
    u, info = app.solve(method, tol=tol, **kw)
    np.save(f"{{TMP}}/u_{{name}}.npy", np.asarray(u, np.float64))
    meta[name] = dict(iterations=info.iterations, relres=info.relres,
                      residuals=np.asarray(info.residuals, np.float64).tolist(),
                      residual_norm=app.residual_norm(u))
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


def reference_solves(tmp, cases: dict, x0=None) -> dict:
    """Run every case ``name: (periodic, method, tol, solver kwargs)`` in the
    reference; returns the metadata (arrays stay in ``tmp``)."""
    if x0 is not None:
        np.save(tmp / "x0.npy", x0)
    run(_SNIPPET.format(tmp=str(tmp), cases=cases), ndev=8, timeout=900)
    return json.loads((tmp / "meta.json").read_text())


def check_solve(app, u, info, tmp, meta, name, tol, f32=False, sol_tol=1e-10):
    """Hold one port solve against the reference's and the oracle."""
    want = meta[name]
    assert info.iterations == want["iterations"], (info.iterations, want["iterations"])
    np.testing.assert_allclose(info.residuals, want["residuals"], rtol=5e-2 if f32 else 1e-6,
                               atol=0.0 if f32 else 0.1 * tol)
    got = app.grid.to_stacked(u).astype(np.float64)
    ref = np.load(tmp / f"u_{name}.npy")
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= (1e-5 if f32 else sol_tol), err
    assert app.residual_norm(u) < 2 * tol
    if not f32:
        G = np.load(tmp / f"oracle_{app.singular}.npy")
        oerr = np.abs(app.grid.gather(u) - G).max() / np.abs(G).max()
        assert oerr < 1e-4, oerr
    assert info.converged and info.relres <= tol
