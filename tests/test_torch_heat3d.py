"""The port's Heat3D (paper Fig. 1) against the JAX package's.

From a seeded non-constant T and Ci, 10 steps at dims (2,2,2), local 16^3,
with communication hiding on and off, against the reference's
``Heat3D.run(nt, T, Ci)`` at rtol 1e-6 in f32 (the frameworks may round the
same expression differently).  The reference runs once in a module-scoped
child process with 8 fake CPU devices; arrays travel as ``.npy`` files.
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
from repro_torch.apps import Heat3D  # noqa: E402
from repro_torch.kernels.stencil3d import heat_step_cuda  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
NT = 10
HIDES = {"hide": (16, 2, 2), "plain": None}

REFERENCE = ALIAS + """
import json
from repro.apps.heat3d import Heat3D

TMP = {tmp!r}
Tg = np.load(TMP + "/T.npy")
Cg = np.load(TMP + "/Ci.npy")
meta = {{}}
for name, hide in {hides!r}.items():
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2),
                 hide=None if hide is None else tuple(hide))
    T, Ci = app.grid.scatter(Tg), app.grid.scatter(Cg)
    T2, _ = app.run({nt}, T, Ci)
    np.save(f"{{TMP}}/run_{{name}}.npy", np.asarray(T2))
    meta[name] = dict(dt=app.dt, dx=app.dx, hide=app._hide_widths,
                      a_eff=app.a_eff_per_step(), halo=app.halo_bytes_per_step(),
                      bpc=app.bytes_per_step_per_cell(), t_eff=app.t_eff(1e-3))
np.save(TMP + "/oracle.npy", app.oracle({nt}))
json.dump(meta, open(TMP + "/meta.json", "w"))
print("OK")
"""


def _fields():
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), device="cpu")
    rng = np.random.RandomState(11)
    shape = app.grid.global_shape
    Tg = (1.7 + rng.rand(*shape)).astype(np.float32)
    Cg = (0.25 + 0.25 * rng.rand(*shape)).astype(np.float32)  # <= 1/c0: stable dt
    return Tg, Cg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_heat3d")
    Tg, Cg = _fields()
    np.save(tmp / "T.npy", Tg)
    np.save(tmp / "Ci.npy", Cg)
    run(REFERENCE.format(tmp=str(tmp), hides=HIDES, nt=NT), ndev=8)
    return tmp, json.loads((tmp / "meta.json").read_text())


@pytest.mark.parametrize("name", list(HIDES))
def test_run_vs_jax(reference, name):
    tmp, meta = reference
    Tg, Cg = _fields()
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), hide=HIDES[name], device="cpu")
    assert app.dt == meta[name]["dt"] and app.dx == meta[name]["dx"]
    assert list(app._hide_widths or []) == list(meta[name]["hide"] or [])
    g = app.grid
    T, Ci = app.run(NT, g.scatter(Tg), g.scatter(Cg))
    got = g.to_stacked(T)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.load(tmp / f"run_{name}.npy"), rtol=1e-6, atol=0)


def test_bookkeeping_vs_jax(reference):
    _, meta = reference
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), device="cpu")
    m = meta["hide"]
    assert app.a_eff_per_step() == m["a_eff"]
    assert app.halo_bytes_per_step() == m["halo"]
    assert app.bytes_per_step_per_cell() == m["bpc"]
    assert app.t_eff(1e-3) == m["t_eff"]


def test_oracle_vs_jax(reference):
    tmp, _ = reference
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), device="cpu")
    np.testing.assert_array_equal(app.oracle(NT), np.load(tmp / "oracle.npy"))


def test_hide_on_off_bitwise_and_one_rank_equals_eight():
    Tg, Cg = _fields()
    runs = {}
    for name, hide in HIDES.items():
        app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), hide=hide, device="cpu")
        g = app.grid
        runs[name] = g.gather(app.run(NT, g.scatter(Tg), g.scatter(Cg))[0])
    np.testing.assert_array_equal(runs["hide"], runs["plain"])
    one = Heat3D(nx=30, ny=30, nz=30, dims=(1, 1, 1), device="cpu")
    g1 = one.grid
    assert g1.global_shape == Tg.shape
    got = g1.gather(one.run(NT, g1.scatter(Tg), g1.scatter(Cg))[0])
    # every cell sees the same operations in the same order on 1 and 8 ranks
    np.testing.assert_array_equal(got, runs["hide"])


def test_run_vs_own_oracle_from_non_constant_start():
    Tg, Cg = _fields()
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), device="cpu")
    g = app.grid
    T, _ = app.run(NT, g.scatter(Tg), g.scatter(Cg))
    G = app.oracle(NT, Tg, Cg)
    assert np.abs(G - Tg).max() > 1e-2   # the start evolves
    np.testing.assert_allclose(g.gather(T), G, rtol=1e-5, atol=1e-5)
    T0, C0 = app.init_fields()
    assert T0.shape == g.shape and float(C0[0, 0, 0, 0, 0, 0]) == 0.5


def test_f64_and_width_2_halo_not_exchanged_twice():
    app = Heat3D(nx=12, ny=12, nz=12, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    g = app.grid
    G = 1.0 + np.random.RandomState(2).rand(*g.global_shape)
    T, _ = app.run(5, g.scatter(G), g.full(0.5))
    assert T.dtype == torch.float64
    np.testing.assert_allclose(g.gather(T), app.oracle(5, G), rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_heat3d_on_card_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Tg, Cg = _fields()
    out = {}
    for name, hide in HIDES.items():
        app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), hide=hide)
        g = app.grid
        n0 = heat_step_cuda.launches
        T, _ = app.run(NT, g.scatter(Tg), g.scatter(Cg))
        assert heat_step_cuda.launches - n0 == NT * (7 if hide else 1)
        out[name] = g.gather(T)
        np.testing.assert_allclose(out[name], app.oracle(NT, Tg, Cg), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["hide"], out["plain"])
