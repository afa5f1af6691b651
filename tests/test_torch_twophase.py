"""The port's two-phase flagship (``apps/twophase.py``, ``twophase_ops.py``)
against the JAX package's, and the three dense configs it registers.

The reference runs once, in a module-scoped child process with 8 fake CPU
devices (f64); its per-step iteration counts and residual histories travel
as JSON, its final fields as ``.npy`` files.  Held:

* the pressure operator, its rhs and the Darcy fluxes against the NumPy
  slicing formulas to 1e-12, and the overlap operator (``hide_apply``)
  against the plain one to 1e-12 (here bitwise);
* per-step pressure iterations EQUAL at 16x12x12 on 2x2x2, ``tol=1e-8``:
  cg [9, 9, 9, 9, 9] and mgcg [5, 5, 5, 4, 4], pipelined as the reference
  ([10] * 5 and [6, 6, 6, 5, 5]); cg with ``overlap=True`` at 10^3 [7, 8];
  periodic (T, T, F) mgcg [5, 5, 5] on 8 blocks and on one;
* residual histories to rtol 1e-6 or atol a tenth of tol (F5 of
  ``ROADMAP.md``: rounding differences of the last CG iterations grow
  about tenfold per iteration; measured on the CPU at most 4.7e-8 relative,
  pipelined mgcg), the final ``Pe`` to 1e-12 of its largest value and
  ``phi`` to 1e-14 (measured at most 7e-16 and 3.5e-18: with equal
  counts the two frameworks' iterates differ by rounding only, and the
  diagonal ``1/dt`` keeps each solve well conditioned), and the periodic
  8-block run against the 1-block run to 1e-12;
* the explicit integrator against the reference and against its own
  oracle, with and without hide, to 1e-11 (``tests/test_apps.py:40``);
* implicit against explicit at small dt to rtol 1e-5, the implicit run
  against the NumPy backward-Euler oracle to 1e-6; stability at 10x the
  explicit dt limit (``tests/test_twophase_implicit.py``);
* the dense configs starcoder2-15b, gemma-2b and llama3.2-1b field for
  field and in parameter count against the reference's ``get(name)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import fields  # noqa: E402
from repro_torch import configs as cb  # noqa: E402
from repro_torch.apps import TwoPhase3D  # noqa: E402
from repro_torch.apps.twophase_ops import pressure_apply  # noqa: E402
from repro_torch.fields import Field, FieldSet  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
TOL = 1e-8
# name: TwoPhase3D keyword arguments, steps
CASES = {
    "cg": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), tol=TOL, method="cg"), 5),
    "mgcg": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), tol=TOL, method="mgcg"), 5),
    "pipecg": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), tol=TOL, method="cg",
                    variant="pipelined"), 5),
    "pipemgcg": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), tol=TOL, method="mgcg",
                      variant="pipelined"), 5),
    "cg_overlap": (dict(nx=10, ny=10, nz=10, dims=(2, 2, 2), method="cg", overlap=True), 2),
    "periodic_8": (dict(nx=10, ny=10, nz=10, dims=(2, 2, 2), method="mgcg", tol=1e-10,
                        periodic=(True, True, False)), 3),
    "periodic_1": (dict(nx=18, ny=18, nz=18, dims=(1, 1, 1), method="mgcg", tol=1e-10,
                        periodic=(True, True, False)), 3),
    "explicit": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), hide=None), 5),
    "explicit_hide": (dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), hide=(2, 2, 2)), 5),
}
ITERATIONS = {"cg": [9] * 5, "mgcg": [5, 5, 5, 4, 4], "pipecg": [10] * 5,
              "pipemgcg": [6, 6, 6, 5, 5], "cg_overlap": [7, 8], "periodic_8": [5, 5, 5],
              "periodic_1": [5, 5, 5], "explicit": [], "explicit_hide": []}
CONFIGS = ("starcoder2-15b", "gemma-2b", "llama3.2-1b")

REFERENCE = ALIAS + """
import dataclasses, json
jax.config.update("jax_enable_x64", True)
from repro import configs, fields
from repro.apps.twophase import TwoPhase3D
from repro.core import make_grid_mesh

TMP = {tmp!r}
meta = {{}}
for name, (kw, nt) in {cases!r}.items():
    kw = dict(kw)
    if kw.get("dims") == (1, 1, 1):
        kw["mesh"] = make_grid_mesh(3, dims=(1, 1, 1), devices=jax.devices()[:1])
    app = TwoPhase3D(**kw)
    S, infos = app.run(nt)
    np.save(f"{{TMP}}/Pe_{{name}}.npy", fields.gather(S.Pe))
    np.save(f"{{TMP}}/phi_{{name}}.npy", fields.gather(S.phi))
    meta[name] = dict(iterations=[i.iterations for i in infos],
                      residuals=[np.asarray(i.residuals, np.float64).tolist() for i in infos],
                      dt=app.dt, dt_limit=app.dt_limit, spacing=list(app.spacing),
                      a_eff=app.a_eff_per_step(), hide_bytes=app.halo_bytes_per_step())
for name in {configs!r}:
    cfg = configs.get(name)
    meta[name] = dict(fields=repr(dataclasses.asdict(cfg)), params=cfg.param_count())
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_twophase")
    run(REFERENCE.format(tmp=str(tmp), cases=CASES, configs=CONFIGS), ndev=8, timeout=900)
    return tmp, json.loads((tmp / "meta.json").read_text())


@pytest.fixture(scope="module")
def runs():
    """Every case of ``CASES`` run once by the port on the CPU."""
    out = {}
    for name, (kw, nt) in CASES.items():
        app = TwoPhase3D(**kw, device="cpu")
        out[name] = (app, *app.run(nt))
    return out


def _np_operator(GPe, Kg, Dg, spacing):
    inner = (slice(1, -1),) * 3
    h2 = np.asarray(spacing) ** 2
    u0, k0 = GPe[inner], Kg[inner]
    acc = np.zeros_like(u0)
    for d in range(3):
        sp = [slice(1, -1)] * 3
        sp[d] = slice(2, None)
        sm = [slice(1, -1)] * 3
        sm[d] = slice(None, -2)
        acc += (0.5 * (k0 + Kg[tuple(sp)]) * (GPe[tuple(sp)] - u0)
                - 0.5 * (k0 + Kg[tuple(sm)]) * (u0 - GPe[tuple(sm)])) / h2[d]
    out = np.zeros_like(GPe)
    out[inner] = Dg[inner] * u0 - acc
    return out


def test_pressure_operator_rhs_and_fluxes_vs_numpy():
    app = TwoPhase3D(nx=10, ny=8, nz=8, dims=(2, 2, 2), method="cg", dt=3e-4, device="cpu")
    g = app.grid
    rng = np.random.RandomState(0)
    GPe = rng.rand(*g.global_shape)
    Gphi = 0.005 + 0.02 * rng.rand(*g.global_shape)
    Kg = (Gphi / app.phi0) ** app.npow
    Dg = 1.0 / app.dt + (app.phi0 / app.eta0) * (Gphi / app.phi0) ** app.m
    Pe, K, D = g.scatter(GPe), g.scatter(Kg), g.scatter(Dg)
    A1 = g.update_halo(pressure_apply(g, Pe.clone(), K, D, app.spacing))
    A2 = g.update_halo(pressure_apply(g, Pe.clone(), K, D, app.spacing, hide=True))
    want = _np_operator(GPe, Kg, Dg, app.spacing)
    np.testing.assert_allclose(g.gather(A1), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.gather(A2), g.gather(A1), rtol=0, atol=1e-12)
    # the Field-level operators of the app are the same function
    for apply_A in (app.apply_A, app.apply_A_overlap):
        out = apply_A(Field(g, Pe.clone()), K, D)
        assert out.loc == "center"
        np.testing.assert_allclose(g.gather(g.update_halo(out.data)), want, rtol=1e-12,
                                   atol=1e-12)

    # rhs: Pe/dt - d_z(k_zface) on the interior, zero ring
    S = FieldSet(Pe=Field(g, Pe), phi=Field(g, g.scatter(Gphi)))
    k2, diag2, rhs = app._assemble(S.Pe, S.phi)
    np.testing.assert_allclose(g.gather(k2), Kg, rtol=1e-13)
    np.testing.assert_allclose(g.gather(diag2), Dg, rtol=1e-13)
    kz = 0.5 * (Kg[1:-1, 1:-1, 1:] + Kg[1:-1, 1:-1, :-1])
    ref_rhs = np.zeros_like(GPe)
    ref_rhs[1:-1, 1:-1, 1:-1] = GPe[1:-1, 1:-1, 1:-1] / app.dt - np.diff(kz, axis=2) / app.dz
    np.testing.assert_allclose(g.gather(g.update_halo(rhs.data)), ref_rhs, rtol=1e-12,
                               atol=1e-12)

    # staggered Darcy fluxes (a face FieldSet) against NumPy on the valid arrays
    Q = app.fluxes(S)
    assert [q.loc for q in Q] == ["xface", "yface", "zface"]
    kxf = 0.5 * (Kg[1:] + Kg[:-1])
    np.testing.assert_allclose(fields.gather(Q.qx), -kxf * np.diff(GPe, axis=0) / app.dx,
                               rtol=1e-12)
    kyf = 0.5 * (Kg[:, 1:] + Kg[:, :-1])
    np.testing.assert_allclose(fields.gather(Q.qy), -kyf * np.diff(GPe, axis=1) / app.dy,
                               rtol=1e-12)
    kzf = 0.5 * (Kg[:, :, 1:] + Kg[:, :, :-1])
    np.testing.assert_allclose(fields.gather(Q.qz), -kzf * (np.diff(GPe, axis=2) / app.dz - 1.0),
                               rtol=1e-12)


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith("explicit")])
def test_implicit_counts_histories_and_fields_vs_reference(reference, runs, name):
    tmp, meta = reference
    app, S, infos = runs[name]
    ref = meta[name]
    assert [i.iterations for i in infos] == ITERATIONS[name] == ref["iterations"]
    assert all(i.converged for i in infos)
    assert app.dt == ref["dt"] and app.dt_limit == ref["dt_limit"]
    assert list(app.spacing) == ref["spacing"] and app.a_eff_per_step() == ref["a_eff"]
    assert app.halo_bytes_per_step() == ref["hide_bytes"]
    tol = CASES[name][0].get("tol", TOL)
    for got, want in zip(infos, ref["residuals"]):
        np.testing.assert_allclose(got.residuals, want, rtol=1e-6, atol=0.1 * tol)
    Pe_ref = np.load(tmp / f"Pe_{name}.npy")
    phi_ref = np.load(tmp / f"phi_{name}.npy")
    Pe, phi = fields.gather(S.Pe), fields.gather(S.phi)
    assert np.isfinite(Pe).all() and Pe.shape == Pe_ref.shape
    np.testing.assert_allclose(Pe, Pe_ref, rtol=0, atol=1e-12 * np.abs(Pe_ref).max())
    np.testing.assert_allclose(phi, phi_ref, rtol=0, atol=1e-14)


def test_periodic_one_block_equals_eight(runs):
    _, S8, _ = runs["periodic_8"]
    app1, S1, _ = runs["periodic_1"]
    assert app1.grid.global_shape == S8.Pe.grid.global_shape
    for k in ("Pe", "phi"):
        a, b = fields.gather(S8[k]), fields.gather(S1[k])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["explicit", "explicit_hide"])
def test_explicit_vs_reference_and_oracle(reference, runs, name):
    tmp, meta = reference
    app, S, infos = runs[name]
    assert infos == [] and meta[name]["iterations"] == []
    assert app.dt == meta[name]["dt"] == app.dt_limit
    Pe, phi = fields.gather(S.Pe), fields.gather(S.phi)
    Pe_o, phi_o = app.oracle(CASES[name][1])
    for got, want, ref in ((Pe, Pe_o, np.load(tmp / f"Pe_{name}.npy")),
                           (phi, phi_o, np.load(tmp / f"phi_{name}.npy"))):
        assert np.abs(got - want).max() < 1e-11
        assert np.abs(got - ref).max() < 1e-11
    # the porosity wave does something: phi changed from its init
    assert np.abs(phi - fields.gather(app.init_fields().phi)).max() > 1e-8
    if name == "explicit_hide":
        assert app._hide_widths == (2, 2, 2)
        _, S0, _ = runs["explicit"]
        for k in ("Pe", "phi"):   # hide_step is update_halo(step) bitwise
            assert torch.equal(S[k].data, S0[k].data), k


def test_periodic_explicit_one_block_equals_eight_bitwise():
    per = (True, True, False)
    S8, _ = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), hide=None, periodic=per,
                       device="cpu").run(5)
    S1, _ = TwoPhase3D(nx=18, ny=18, nz=18, hide=None, periodic=per, device="cpu").run(5)
    Sh, _ = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), hide=(2, 2, 2), periodic=per,
                       device="cpu").run(5)
    for k in ("Pe", "phi"):
        np.testing.assert_array_equal(fields.gather(S8[k]), fields.gather(S1[k]))
        np.testing.assert_array_equal(fields.gather(Sh[k]), fields.gather(S1[k]))
    app = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=per, device="cpu")
    for q in app.fluxes(S8):
        assert torch.isfinite(q.data).all()


def test_implicit_matches_explicit_small_dt():
    kw = dict(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    dt = 1e-8
    ex = TwoPhase3D(**kw, hide=None, dt=dt)
    assert ex.dt == dt            # below the stability limit: not clamped
    Se, infos_e = ex.run(10)
    im = TwoPhase3D(**kw, method="mgcg", dt=dt, tol=1e-12)
    Si, infos = im.run(10)
    assert len(infos) == 10 and all(i.converged for i in infos) and infos_e == []
    Pe_e, Pe_i = fields.gather(Se.Pe), fields.gather(Si.Pe)
    phi_e, phi_i = fields.gather(Se.phi), fields.gather(Si.phi)
    assert np.abs(Pe_i - Pe_e).max() / np.abs(Pe_e).max() < 1e-5
    assert np.abs(phi_i - phi_e).max() / np.abs(phi_e).max() < 1e-5
    Pe_ref, phi_ref = im.oracle(10)
    assert np.abs(Pe_i - Pe_ref).max() / np.abs(Pe_ref).max() < 1e-6
    assert np.abs(phi_i - phi_ref).max() < 1e-12


def test_implicit_stable_beyond_explicit_limit():
    kw = dict(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    ex = TwoPhase3D(**kw, hide=None, dt=1.0)       # clamped to the limit
    assert ex.dt == ex.dt_limit
    im = TwoPhase3D(**kw, method="mgcg")           # default dt: 10x the limit
    assert im.dt >= 10.0 * ex.dt_limit
    Si, infos = im.run(20)
    assert all(i.converged for i in infos)
    Pe, phi = fields.gather(Si.Pe), fields.gather(Si.phi)
    assert np.isfinite(Pe).all() and np.isfinite(phi).all()
    assert np.abs(Pe).max() < 10.0
    assert phi.min() >= 1e-4 and phi.max() <= 0.25
    ic = TwoPhase3D(**kw, method="cg", dt=im.dt, tol=1e-10)
    im2 = TwoPhase3D(**kw, method="mgcg", dt=im.dt, tol=1e-10)
    Sc, infos_c = ic.run(5)
    Sm, infos_m = im2.run(5)
    assert np.abs(fields.gather(Sc.Pe) - fields.gather(Sm.Pe)).max() < 1e-7
    # the Helmholtz-shifted cycle must actually help
    assert sum(i.iterations for i in infos_m) < sum(i.iterations for i in infos_c)


def test_what_the_app_rejects():
    with pytest.raises(ValueError, match="unknown method"):
        TwoPhase3D(method="sor", device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        TwoPhase3D(periodic=(True,), device="cpu")
    with pytest.raises(ValueError, match="coarsen"):
        TwoPhase3D(nx=7, ny=7, nz=7, dims=(2, 2, 2), method="mgcg", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        TwoPhase3D(nx=10, ny=10, nz=10, method="cg", variant="chronopoulos",
                   device="cpu").run(1)
    with pytest.raises(ValueError, match="CUDA"):
        TwoPhase3D(nx=10, ny=10, nz=10, method="mgcg", use_kernel="cuda", device="cpu").run(1)


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoPhase3D()
    assert TwoPhase3D(nx=8, ny=8, nz=8, device="cpu").grid.device.type == "cpu"


@pytest.mark.parametrize("name", CONFIGS)
def test_dense_configs_equal_reference(reference, name):
    _, meta = reference
    cfg = cb.get(name)
    assert cfg.name == name and name in cb.names() and name not in cb.base.LATER
    assert repr(dataclasses.asdict(cfg)) == meta[name]["fields"]
    assert cfg.param_count() == meta[name]["params"]
