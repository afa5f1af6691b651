"""Face-located multigrid of the port against the JAX package.

The reference's configuration of ``tests/test_solvers.py:572-610``: local
10^3 on ``dims=(2, 2, 2)`` (18^3 global), f64, spacing 0.1, a random center
coefficient and a smooth face-located rhs masked to the location's
unknowns.  For each face location and both smoothers:

* ``multigrid_solve`` on the face Field (``tol=1e-10``): cycle count EQUAL,
  residual history and solution by the rules of ``tests/_poisson_ref.py``
  (history rtol 1e-6 or atol 0.1 tol; solution 1e-10 of its largest
  value), a Field of the same location back;
* CG preconditioned by the per-location ``CyclePreconditioner`` on the face
  Field (``tol=1e-10``): iteration count EQUAL, same rules, and the solution
  agrees with the multigrid one to 1e-8 (the reference's own criterion).

The reference runs once in a module-scoped child process with 8 fake CPU
devices; the coefficient and rhs travel from it as stacked arrays.
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
from repro_torch import convert, fields, solvers  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.solvers.multigrid import face_stencil  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
LOCS = ("xface", "yface", "zface")
SMOOTHERS = ("jacobi", "chebyshev")
SP = (0.1, 0.1, 0.1)
TOL = 1e-10

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid
from repro import fields, solvers
from repro.solvers.multigrid import face_stencil

TMP = {tmp!r}
SP, TOL = {sp!r}, {tol!r}
g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=jnp.float64)
rng = np.random.RandomState(0)
c = fields.Field(g, g.update_halo_g(
    fields.scatter(g, 1.0 + 0.5 * rng.rand(*g.global_shape)).data), "center")
np.save(TMP + "/c.npy", np.asarray(c.data))
meta = {{}}
for loc in {locs!r}:
    sd = fields.stagger_dim(loc)
    b = fields.from_global_fn(
        g, lambda ix, iy, iz: jnp.sin(ix * 0.3) + jnp.cos(iy * 0.2 + iz * 0.1), loc)

    @g.parallel
    def maskb(b, loc=loc):
        return b.with_data(b.data * fields.interior_mask(g, loc, jnp.float64)
                           * fields.valid_mask(g, loc, jnp.float64))

    b = maskb(b)
    np.save(f"{{TMP}}/b_{{loc}}.npy", np.asarray(b.data))
    for smoother in {smoothers!r}:
        x, info = solvers.multigrid_solve(g, c, b, SP, tol=TOL, smoother=smoother)
        assert x.loc == loc
        np.save(f"{{TMP}}/mg_{{loc}}_{{smoother}}.npy", np.asarray(x.data))
        meta[f"mg_{{loc}}_{{smoother}}"] = dict(
            iterations=info.iterations, residuals=np.asarray(info.residuals).tolist())

    def apply_A(u, c, loc=loc, sd=sd):
        u = fields.update_halo(g, u)
        m = fields.interior_mask(g, loc, jnp.float64)
        return u.with_data(face_stencil(u.data, c.data, SP, sd) * m)

    x, info = solvers.cg(g, apply_A, b, tol=TOL, args=(c,),
                         apply_M=solvers.CyclePreconditioner(g, SP))
    np.save(f"{{TMP}}/mgcg_{{loc}}.npy", np.asarray(x.data))
    meta[f"mgcg_{{loc}}"] = dict(iterations=info.iterations,
                                 residuals=np.asarray(info.residuals).tolist())
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_face_mg")
    run(REFERENCE.format(tmp=str(tmp), sp=SP, tol=TOL, locs=LOCS, smoothers=SMOOTHERS), ndev=8,
        timeout=900)
    return tmp, json.loads((tmp / "meta.json").read_text())


def _setup(tmp, loc):
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    c = convert.field_from_reference(g, np.load(tmp / "c.npy"), "center")
    b = convert.field_from_reference(g, np.load(tmp / f"b_{loc}.npy"), loc)
    return g, c, b


def _check(g, x, info, tmp, meta, name):
    want = meta[name]
    assert info.iterations == want["iterations"], (name, info.iterations, want["iterations"])
    np.testing.assert_allclose(info.residuals, want["residuals"], rtol=1e-6, atol=0.1 * TOL)
    ref = np.load(tmp / f"{name}.npy")
    got = g.to_stacked(x.data)
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max(), name
    assert info.converged and info.relres <= TOL


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("loc", LOCS)
def test_face_multigrid_solve_equals_reference(reference, loc, smoother):
    tmp, meta = reference
    g, c, b = _setup(tmp, loc)
    x, info = solvers.multigrid_solve(g, c, b, SP, tol=TOL, smoother=smoother)
    assert isinstance(x, fields.Field) and x.loc == loc
    _check(g, x, info, tmp, meta, f"mg_{loc}_{smoother}")


@pytest.mark.parametrize("loc", LOCS)
def test_per_location_cycle_preconditioned_cg_equals_reference(reference, loc):
    tmp, meta = reference
    g, c, b = _setup(tmp, loc)
    sd = fields.stagger_dim(loc)
    m = fields.interior_mask(g, loc)

    def apply_A(u, c):
        u = fields.update_halo(g, u)
        return u.with_data(face_stencil(u.data, c.data, SP, sd) * m)

    x, info = solvers.cg(g, apply_A, b, tol=TOL, args=(c,),
                         apply_M=solvers.CyclePreconditioner(g, SP))
    assert isinstance(x, fields.Field) and x.loc == loc
    _check(g, x, info, tmp, meta, f"mgcg_{loc}")
    xm, _ = solvers.multigrid_solve(g, c, b, SP, tol=TOL)
    err = np.abs(fields.gather(xm) - fields.gather(x)).max() / np.abs(fields.gather(x)).max()
    assert err < 1e-8, err


def test_face_cycle_rejects_what_the_reference_rejects():
    g = init_global_grid(10, 10, 10, dtype=torch.float64, device="cpu")
    grids = g.hierarchy()
    hs = solvers.level_spacings(g, grids, SP)
    cs = solvers.build_coefficients(g, grids, g.ones())
    with pytest.raises(ValueError, match="center cycle"):
        solvers.make_v_cycle(g, grids, hs, cs, loc="xface", shifts=cs)
    shifted = solvers.CyclePreconditioner(g, SP, helmholtz_shift=True)
    with pytest.raises(ValueError, match="second operator arg"):
        shifted.setup(g.ones())
    with pytest.raises(ValueError, match="center cycle"):   # a face leaf of a shifted cycle
        shifted.setup(g.ones(), g.ones())(fields.Field(g, g.ones(), "xface"))
    M = solvers.CyclePreconditioner(g, SP, per_location=False).setup(g.ones())
    face = M(fields.Field(g, g.ones(), "yface"))    # the center cycle on a face leaf
    assert face.loc == "yface" and face.shape == g.shape
