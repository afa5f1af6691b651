"""``repro_torch.solvers.restrict_full_weighting`` and ``prolong_trilinear``,
the reference's public center-only names of the grid transfers, against
the JAX package's (``src/repro/solvers/multigrid.py:203-210``).

The round trip of ``tests/test_solvers.py:215-247`` on 8 blocks of a 18^3
global f64 grid: restrict, halo update, prolong, halo update.  On the
all-ones field the coarse interior is 1 and the fine cells away from the
zero ring are 1 (atol 1e-13, the reference's check); on the ones field and
on a seeded random field both results equal the reference's to 1e-14
(rtol = atol; the same weights, summed in the same order).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid
from repro.solvers import prolong_trilinear, restrict_full_weighting

TMP = {tmp!r}
grid = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=jnp.float64)
coarse = grid.coarsen()

def roundtrip(u):
    rc = grid.update_halo(restrict_full_weighting(u))
    return rc, grid.update_halo(prolong_trilinear(rc))

sm = jax.jit(jax.shard_map(roundtrip, mesh=grid.mesh, in_specs=(grid.spec,),
                           out_specs=(grid.spec, grid.spec), check_vma=False))
for name, u in (("ones", grid.ones(jnp.float64)),
                ("rand", grid.scatter(np.load(TMP + "/rand.npy")))):
    R, Pl = sm(u)
    np.save(f"{{TMP}}/R_{{name}}.npy", coarse.gather(R))
    np.save(f"{{TMP}}/P_{{name}}.npy", grid.gather(Pl))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_transfer_aliases")
    np.save(tmp / "rand.npy", np.random.RandomState(7).rand(18, 18, 18))
    run(REFERENCE.format(tmp=str(tmp)), ndev=8)
    return tmp


def _roundtrip(grid, coarse, u):
    rc = coarse.update_halo(solvers.restrict_full_weighting(u))
    pl = grid.update_halo(solvers.prolong_trilinear(rc))
    return coarse.gather(rc), grid.gather(pl)


@pytest.mark.parametrize("field", ["ones", "rand"])
def test_aliases_vs_reference(reference, field):
    grid = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    coarse = grid.coarsen()
    u = grid.ones() if field == "ones" else grid.scatter(np.load(reference / "rand.npy"))
    R, Pl = _roundtrip(grid, coarse, u)
    if field == "ones":
        np.testing.assert_allclose(R[1:-1, 1:-1, 1:-1], 1.0, atol=1e-13)
        np.testing.assert_allclose(Pl[2:-2, 2:-2, 2:-2], 1.0, atol=1e-13)
    np.testing.assert_allclose(R, np.load(reference / f"R_{field}.npy"), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(Pl, np.load(reference / f"P_{field}.npy"), rtol=1e-14, atol=1e-14)


def test_aliases_are_the_center_transfers():
    a = torch.from_numpy(np.random.RandomState(2).rand(2, 1, 1, 10, 6, 8))
    assert torch.equal(solvers.restrict_full_weighting(a), solvers.transfers.restrict(a, "center"))
    assert torch.equal(solvers.prolong_trilinear(a), solvers.transfers.prolong(a, "center"))
    assert {"restrict_full_weighting", "prolong_trilinear"} <= set(solvers.__all__)
