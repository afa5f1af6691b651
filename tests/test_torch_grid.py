"""The port's implicit global grid against the JAX package's.

Sizes, ``gather``/``scatter``, coordinates and the stacked-layout
round-trips at dims (2,2,2), (4,2,1) and (8,1,1).  The reference runs once,
in a module-scoped child process with 8 fake CPU devices; arrays travel as
``.npy`` files made from a numpy seed.  The port runs on ``device="cpu"``.
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
from repro_torch.convert import fields_from_reference, fields_to_reference  # noqa: E402
from repro_torch.core import dims_create, init_global_grid  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# name: local shape, dims, periodic
CASES = {
    "222": ((10, 8, 6), (2, 2, 2), (False, False, False)),
    "421": ((7, 9, 6), (4, 2, 1), (True, False, False)),
    "811": ((6, 5, 12), (8, 1, 1), (False, True, True)),
}

REFERENCE = ALIAS + """
import json
from repro.core import init_global_grid
from repro.core.topology import dims_create

TMP = {tmp!r}
cases = json.load(open(TMP + "/cases.json"))
sizes = {{"dims_create": [list(dims_create(n, k)) for n in (1, 6, 8, 12, 36) for k in (1, 2, 3)]}}
for name, (local, dims, periodic) in cases.items():
    g = init_global_grid(*local, dims=tuple(dims), periodic=tuple(periodic))
    sizes[name] = dict(
        dims=list(g.dims), n_g=[g.n_g(d) for d in range(3)],
        nxyz_g=[g.nx_g(), g.ny_g(), g.nz_g()], global_shape=list(g.global_shape),
        span=[g.span(d) for d in range(3)], stacked_shape=list(g.stacked_shape),
        local_shape=list(g.local_shape), halo=g.halo)
    A = np.load(f"{{TMP}}/{{name}}_stacked.npy")
    G = np.load(f"{{TMP}}/{{name}}_global.npy")
    np.save(f"{{TMP}}/{{name}}_gather.npy", g.gather(jnp.asarray(A)))
    np.save(f"{{TMP}}/{{name}}_scatter.npy", np.asarray(g.scatter(G)))
    for d in range(3):
        np.save(f"{{TMP}}/{{name}}_coords{{d}}.npy", np.asarray(g.coords(d, 0.25, -1.5)))
    np.save(f"{{TMP}}/{{name}}_fn.npy", np.asarray(
        g.from_global_fn(lambda i, j, k: 10000 * i + 100 * j + k)))
json.dump(sizes, open(TMP + "/sizes.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_grid")
    rng = np.random.RandomState(1)
    data = {}
    for name, (local, dims, periodic) in CASES.items():
        g = init_global_grid(*local, dims=dims, periodic=periodic, device="cpu")
        A = rng.rand(*g.stacked_shape).astype(np.float32)
        G = rng.rand(*g.global_shape).astype(np.float32)
        np.save(tmp / f"{name}_stacked.npy", A)
        np.save(tmp / f"{name}_global.npy", G)
        data[name] = (A, G)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    run(REFERENCE.format(tmp=str(tmp)), ndev=8)
    return tmp, data, json.loads((tmp / "sizes.json").read_text())


def _grid(name):
    local, dims, periodic = CASES[name]
    return init_global_grid(*local, dims=dims, periodic=periodic, device="cpu")


def test_dims_create_vs_jax(reference):
    _, _, sizes = reference
    got = [list(dims_create(n, k)) for n in (1, 6, 8, 12, 36) for k in (1, 2, 3)]
    assert got == sizes["dims_create"]


@pytest.mark.parametrize("name", list(CASES))
def test_sizes_vs_jax(reference, name):
    _, _, sizes = reference
    g = _grid(name)
    ref = sizes[name]
    assert list(g.dims) == ref["dims"]
    assert [g.n_g(d) for d in range(3)] == ref["n_g"]
    assert [g.nx_g(), g.ny_g(), g.nz_g()] == ref["nxyz_g"]
    assert list(g.global_shape) == ref["global_shape"]
    assert [g.span(d) for d in range(3)] == ref["span"]
    assert list(g.stacked_shape) == ref["stacked_shape"]
    assert list(g.local_shape) == ref["local_shape"]
    assert g.halo == ref["halo"]
    assert g.shape == tuple(ref["dims"]) + tuple(ref["local_shape"])


@pytest.mark.parametrize("name", list(CASES))
def test_gather_scatter_vs_jax(reference, name):
    tmp, data, _ = reference
    g = _grid(name)
    A, G = data[name]
    # the stacked layout round-trips exactly
    F = g.from_stacked(A)
    assert F.shape == g.shape and F.is_contiguous()
    np.testing.assert_array_equal(g.to_stacked(F), A)
    # block (bx, by, bz) of the field is the reference's stacked block
    lx, ly, lz = g.local_shape
    np.testing.assert_array_equal(F[1 % g.dims[0], 0, 0].numpy(),
                                  A[(1 % g.dims[0]) * lx:(1 % g.dims[0] + 1) * lx, :ly, :lz])
    np.testing.assert_array_equal(g.gather(F), np.load(tmp / f"{name}_gather.npy"))
    S = g.scatter(G)
    np.testing.assert_array_equal(g.to_stacked(S), np.load(tmp / f"{name}_scatter.npy"))
    np.testing.assert_array_equal(g.gather(S), G)


@pytest.mark.parametrize("name", list(CASES))
def test_coords_and_from_global_fn_vs_jax(reference, name):
    tmp, _, _ = reference
    g = _grid(name)
    for d in range(3):
        np.testing.assert_array_equal(g.to_stacked(g.coords(d, 0.25, -1.5)),
                                      np.load(tmp / f"{name}_coords{d}.npy"))
    F = g.from_global_fn(lambda i, j, k: 10000 * i + 100 * j + k)
    np.testing.assert_array_equal(g.to_stacked(F), np.load(tmp / f"{name}_fn.npy"))


def test_allocation_and_conversion():
    g = init_global_grid(6, 7, 8, dims=(2, 1, 2), dtype=torch.float64, device="cpu")
    for f, v in ((g.zeros(), 0.0), (g.ones(), 1.0), (g.full(2.5), 2.5)):
        assert f.shape == (2, 1, 2, 6, 7, 8) and f.dtype == torch.float64
        assert bool((f == v).all())
    assert g.zeros(torch.bfloat16).dtype == torch.bfloat16
    rng = np.random.RandomState(2)
    A, B = rng.rand(*g.stacked_shape), rng.rand(*g.stacked_shape)
    Ta, Tb = fields_from_reference(g, A, B)
    a, b = fields_to_reference(g, Ta, Tb)
    np.testing.assert_array_equal(a, A)
    np.testing.assert_array_equal(b, B)
    np.testing.assert_array_equal(fields_to_reference(g, fields_from_reference(g, A)), A)
    assert g.parallel(len) is len
    g.finalize()


def test_grid_2d_and_1d_layout():
    g2 = init_global_grid(8, 6, None, dims=(4, 2), device="cpu")
    assert g2.ndims == 2 and g2.shape == (4, 2, 8, 6) and g2.global_shape == (26, 10)
    G = np.arange(26 * 10, dtype=np.float32).reshape(26, 10)
    np.testing.assert_array_equal(g2.gather(g2.scatter(G)), G)
    g1 = init_global_grid(10, None, None, dims=(8,), periodic=(True,), device="cpu")
    assert g1.shape == (8, 10) and g1.global_shape == (66,) and g1.span(0) == 64


def test_grid_argument_checks():
    with pytest.raises(ValueError, match="even"):
        init_global_grid(8, 8, 8, overlap=3, device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        init_global_grid(8, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        init_global_grid(8, 8, 8, dims=(2, 2), device="cpu")
    g = init_global_grid(8, 8, 8, dims=(2, 2, 2), device="cpu")
    with pytest.raises(ValueError):
        g.scatter(np.zeros((3, 3, 3)))
    with pytest.raises(ValueError):
        g.from_stacked(np.zeros((3, 3, 3)))
    with pytest.raises(ValueError):
        g.to_stacked(torch.zeros(3, 3, 3))


def test_topology_rank_tests():
    g = init_global_grid(8, 8, 8, dims=(4, 2, 1), periodic=(True, False, False), device="cpu")
    t = g.topo
    assert t.shift_perm(0, 1) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert t.shift_perm(1, -1) == [(1, 0)]
    first, last = t.is_first(0), t.is_last(1)
    assert first.shape == (4, 1, 1, 1, 1, 1) and last.shape == (1, 2, 1, 1, 1, 1)
    assert first.flatten().tolist() == [True, False, False, False]
    assert last.flatten().tolist() == [False, True]
    ix, iy, iz = g.local_global_indices()
    assert ix.shape == (4, 1, 1, 8, 1, 1)
    assert ix[1, 0, 0, :, 0, 0].tolist() == list(range(6, 14))
