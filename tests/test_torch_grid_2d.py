"""2-D and 1-D implicit global grids of the port against the JAX package:
the two cases of ``tests/test_grid_2d.py``.

* 2-D diffusion on ``dims=(4, 2)`` blocks of 10 x 8 in f64 (``fd2d``
  stencil), six steps: ``hide`` with ``width=(2, 2)`` equals plain
  ``update_halo`` BITWISE, the gathered field equals the NumPy oracle
  within 1e-12, and the reference's gathered field (hide and plain) within
  1e-14;
* a 1-D periodic ring, ``dims=(8,)``: the halo planes equal the
  neighbours' send planes exactly, and the whole field equals the
  reference's bitwise.

The rest of the 2-D/1-D surface (``coords``, ``from_global_fn``, ``scatter``
/ ``gather``) is held against NumPy, and each of the 14 ``fd2d`` operators
against the reference's to 1e-15.  The reference runs once, in a module-scoped
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
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.stencil import fd2d as fd  # noqa: E402

# The reference needs this alias on jax 0.9; it is set only in the child.
ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
STEPS = 6

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid
from repro.stencil import fd2d as fd

TMP = {tmp!r}
grid = init_global_grid(10, 8, None, dims=(4, 2), dtype=jnp.float64)
G0 = np.load(TMP + "/g2d.npy")
T = grid.scatter(G0)

def step(T):
    return T.at[1:-1, 1:-1].set(fd.inn(T) + 0.1 * (fd.d2_xi(T) + fd.d2_yi(T)))

plain = grid.parallel(lambda T: grid.update_halo(step(T)))
hidden = grid.parallel(lambda T: grid.hide(step, (T,), width=(2, 2)))
Tp, Th = T, T
for _ in range({steps}):
    Tp = plain(Tp)
    Th = hidden(Th)
np.save(TMP + "/ref2d_plain.npy", grid.gather(Tp))
np.save(TMP + "/ref2d_hide.npy", grid.gather(Th))

g1 = init_global_grid(10, None, None, dims=(8,), periodic=(True,), dtype=jnp.float64)
T1 = g1.parallel(lambda T: g1.update_halo(T))(g1.scatter(np.load(TMP + "/g1d.npy")))
np.save(TMP + "/ref1d.npy", np.asarray(T1))

A = jnp.asarray(np.load(TMP + "/a2d.npy"))
for name in fd.__all__:
    np.save(TMP + f"/fd_{{name}}.npy", np.asarray(getattr(fd, name)(A)))
print(json.dumps(fd.__all__))
print("REF OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("grid2d"))
    np.save(f"{tmp}/g2d.npy", np.random.RandomState(0).rand(34, 14))
    np.save(f"{tmp}/g1d.npy", np.random.RandomState(1).rand(66))
    np.save(f"{tmp}/a2d.npy", np.random.RandomState(2).rand(7, 9))
    out = run(REFERENCE.format(tmp=tmp, steps=STEPS), ndev=8)
    assert "REF OK" in out
    assert json.loads(out.splitlines()[-2]) == fd.__all__    # the same 14 names
    return tmp


def step(T):
    out = T.clone()
    out[..., 1:-1, 1:-1] = fd.inn(T) + 0.1 * (fd.d2_xi(T) + fd.d2_yi(T))
    return out


def oracle(G, steps):
    for _ in range(steps):
        Gn = G.copy()
        i = G[1:-1, 1:-1]
        Gn[1:-1, 1:-1] = i + 0.1 * (G[2:, 1:-1] - 2 * i + G[:-2, 1:-1]
                                    + G[1:-1, 2:] - 2 * i + G[1:-1, :-2])
        G = Gn
    return G


def test_2d_diffusion_matches_oracle_and_reference(reference):
    grid = init_global_grid(10, 8, None, dims=(4, 2), dtype=torch.float64, device="cpu")
    assert grid.ndims == 2 and grid.dims == (4, 2) and grid.global_shape == (34, 14)
    G0 = np.load(f"{reference}/g2d.npy")
    Tp = grid.scatter(G0)
    Th = Tp.clone()
    for _ in range(STEPS):
        Tp = grid.update_halo(step(Tp))
        Th = grid.hide(step, (Th,), width=(2, 2))
    assert torch.equal(Tp, Th)                         # hide bitwise
    got = grid.gather(Tp)
    assert np.abs(got - oracle(G0, STEPS)).max() < 1e-12
    for name in ("plain", "hide"):
        ref = np.load(f"{reference}/ref2d_{name}.npy")
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-14, name


def test_1d_periodic_ring(reference):
    grid = init_global_grid(10, None, None, dims=(8,), periodic=(True,), dtype=torch.float64,
                            device="cpu")
    assert grid.ndims == 1 and grid.global_shape == (66,)
    T = grid.update_halo(grid.scatter(np.load(f"{reference}/g1d.npy")))
    b = T.numpy()
    n, D = grid.local_shape[0], grid.dims[0]
    for i in range(D):
        assert b[i][0] == b[(i - 1) % D][n - 2]
        assert b[i][-1] == b[(i + 1) % D][1]
    np.testing.assert_array_equal(grid.to_stacked(T), np.load(f"{reference}/ref1d.npy"))


@pytest.mark.parametrize("local,dims,periodic", [
    ((10, 8), (4, 2), (False, False)),
    ((7, 9), (2, 3), (True, False)),
    ((10,), (8,), (True,)),
    ((6,), (1,), (False,)),
])
def test_lower_rank_surface(local, dims, periodic):
    """coords / from_global_fn / scatter / gather on rank-2 and rank-1
    grids against NumPy on the global array."""
    grid = init_global_grid(*local, *([None] * (3 - len(local))), dims=dims,
                            periodic=periodic, dtype=torch.float64, device="cpu")
    nd = len(local)
    assert grid.shape == tuple(dims) + tuple(local)
    G = np.random.RandomState(3).rand(*grid.global_shape)
    A = grid.scatter(G)
    np.testing.assert_array_equal(grid.gather(A), G)
    for d in range(nd):
        idx = np.arange(grid.global_shape[d], dtype=np.float64)
        want = np.broadcast_to(0.5 + 0.25 * idx.reshape([-1 if e == d else 1 for e in range(nd)]),
                               grid.global_shape)
        np.testing.assert_array_equal(grid.gather(grid.coords(d, spacing=0.25, origin=0.5)), want)
    F = grid.from_global_fn(lambda *ix: sum((k + 1) * i for k, i in enumerate(ix)))
    want = sum((k + 1) * np.arange(n).reshape([-1 if e == k else 1 for e in range(nd)])
               for k, n in enumerate(grid.global_shape))
    np.testing.assert_array_equal(grid.gather(F), np.broadcast_to(want, grid.global_shape))


@pytest.mark.parametrize("name", fd.__all__)
def test_fd2d_operator(reference, name):
    """Each fd2d operator equals the reference's on one 2-D array (to 1e-15:
    the frameworks may fuse the sums differently), and on a field with
    block axes it acts on every block alone."""
    op = getattr(fd, name)
    a = np.load(f"{reference}/a2d.npy")
    want = np.load(f"{reference}/fd_{name}.npy")
    got = op(torch.from_numpy(a)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    field = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 7, 9))
    out = op(field)
    for i in range(2):
        for j in range(3):
            assert torch.equal(out[i, j], op(field[i, j]))
