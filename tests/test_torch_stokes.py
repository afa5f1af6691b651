"""The port's staggered Stokes flagship (velocity block) against the JAX
package's ``apps/stokes.py``.

The reference's test configuration: ``Stokes3D(nx=8, ny=8, nz=8,
dims=(2, 2, 2))``, 14^3 global, f64.

* the app's own viscosity and forcing equal the reference's to 1e-14;
* ``apply_A`` (full and stripped stress, no-slip and free-slip) on a random
  masked velocity equals the reference's on 8 blocks (1e-13 of its largest
  value) and the NumPy oracle's application on the gathered arrays on 1 and
  8 blocks (1e-12);
* classic velocity solves at ``tol=1e-8`` with every preconditioner
  (``"face"``, ``"stress"``, ``None``, ``"center"``), stripped stress with
  ``"face"`` and free slip with ``"stress"``, from the reference's viscosity
  and forcing, by the rules of ``tests/_stokes_ref.py`` (iteration counts
  EQUAL).

The reference runs once in a module-scoped child process with 8 fake CPU
devices; fields travel as stacked arrays (``repro_torch.convert``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _stokes_ref import (  # noqa: E402
    COMPS, FACES, check_velocity_solve, port_app, reference_velocity_solves,
)
from repro_torch import fields  # noqa: E402
from repro_torch.apps import Stokes3D  # noqa: E402
from repro_torch.fields import FieldSet  # noqa: E402

# name: (stress, bc, precond, variant); the pipelined schedules are in
# tests/test_torch_stokes_pipelined.py
SOLVES = {
    "face": ("full", "noslip", "face", "classic"),
    "stress": ("full", "noslip", "stress", "classic"),
    "none": ("full", "noslip", None, "classic"),
    "center": ("full", "noslip", "center", "classic"),
    "stripped_face": ("stripped", "noslip", "face", "classic"),
    "freeslip_stress": ("full", "freeslip", "stress", "classic"),
}
OPERATORS = [(s, bc) for s in ("full", "stripped") for bc in ("noslip", "freeslip")]

# the reference's operator on a random masked velocity, every (stress, bc)
OPERATOR_SNIPPET = """
from repro import fields
g = base.grid
V = fields.FieldSet(**{{k: fields.Field(g, jnp.asarray(np.load(f"{{TMP}}/rand_{{k}}.npy")), loc)
                       for k, loc in zip(("vx", "vy", "vz"), ("xface", "yface", "zface"))}})
for stress, bc in {operators!r}:
    app = app_for(stress, bc)

    @g.parallel
    def A(V, eta):
        return fields.update_halo(g, app.apply_A(V, eta))

    AV = A(V, app.eta)
    for k in ("vx", "vy", "vz"):
        np.save(f"{{TMP}}/AV_{{stress}}_{{bc}}_{{k}}.npy", np.asarray(AV[k].data))
"""


def _random_velocity(g, seed=0):
    """A random velocity, zero outside each component's unknown faces."""
    rng = np.random.RandomState(seed)
    return FieldSet(**{k: fields.Field(g, g.scatter(rng.randn(*g.global_shape)) *
                                       fields.interior_mask(g, loc), loc)
                       for k, loc in zip(COMPS, FACES)})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stokes")
    g = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu").grid
    for k, f in _random_velocity(g).items():
        np.save(tmp / f"rand_{k}.npy", g.to_stacked(f.data))
    meta = reference_velocity_solves(tmp, SOLVES, OPERATOR_SNIPPET.format(operators=OPERATORS))
    return tmp, meta


def test_fields_and_constants_equal_reference(reference):
    tmp, meta = reference
    app = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), device="cpu")
    g = app.grid
    assert list(app.spacing) == meta["spacing"]
    assert app.a_eff_per_iteration() == meta["a_eff"]
    np.testing.assert_allclose(g.to_stacked(app.eta.data), np.load(tmp / "eta.npy"),
                               rtol=1e-14, atol=1e-14)
    for k, loc in zip(COMPS, FACES):
        assert app.F[k].loc == loc
        np.testing.assert_allclose(g.to_stacked(app.F[k].data), np.load(tmp / f"F_{k}.npy"),
                                   rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("stress,bc", OPERATORS)
def test_operator_equals_reference_and_oracle(reference, stress, bc):
    tmp, _ = reference
    for dims in ((2, 2, 2), (1, 1, 1)):
        app = port_app(tmp, stress, bc) if dims == (2, 2, 2) else \
            Stokes3D(nx=14, ny=14, nz=14, stress=stress, bc=bc, device="cpu")
        g = app.grid
        rng = np.random.RandomState(0)
        V = FieldSet(**{k: fields.Field(g, g.scatter(rng.randn(*g.global_shape))
                                        * fields.interior_mask(g, loc), loc)
                        for k, loc in zip(COMPS, FACES)})
        raw = [g.gather(V[k].data) for k in COMPS]
        AV = fields.update_halo(g, app.apply_A(V, app.eta))
        ref = app.oracle_apply(raw)
        scale = max(np.abs(r).max() for r in ref)
        for i, k in enumerate(COMPS):
            assert AV[k].loc == FACES[i]
            err = np.abs(g.gather(AV[k].data) - ref[i]).max() / scale
            assert err < 1e-12, (stress, bc, dims, k, err)
            if dims == (2, 2, 2):
                want = np.load(tmp / f"AV_{stress}_{bc}_{k}.npy")
                np.testing.assert_allclose(g.to_stacked(AV[k].data), want, rtol=0,
                                           atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("name", list(SOLVES))
def test_velocity_solve_equals_reference(reference, name):
    tmp, meta = reference
    check_velocity_solve(tmp, meta, name, SOLVES[name])


def test_precond_names_and_validation():
    app = Stokes3D(nx=8, ny=8, nz=8, device="cpu")
    assert app._precond(True) is app._precond("stress") and app._precond(False) is None
    with pytest.raises(ValueError, match="unknown precond"):
        app._precond("jacobi")
    with pytest.raises(ValueError, match="unknown stress"):
        Stokes3D(stress="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown bc"):
        Stokes3D(bc="slip", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        app.solve(method="gmres")
    assert app.eta.device.type == "cpu" and app.F.vx.loc == "xface"
    assert app.dtype == torch.float64
