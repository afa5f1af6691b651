"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's.

* the three cases of ``tests/test_ckpt.py``: a grid-field round trip (two
  fields and a 0-d step counter, the latest step found), the mid-solve
  restart of ``Poisson3D`` cg (a tol-1e-3 solve saved through ``gather``,
  restored, ``scatter``ed and warm-started: fewer iterations than cold, the
  same field to 1e-6 relative — the reference's criterion — and the
  iteration counts EQUAL to the reference's), and ``async_save`` with a
  device for every leaf;
* cross-package files: the reference writes ``{"G": gather(u),
  "iteration": 123}`` and the port restores it bitwise, and the other way
  round, with the same file names;
* restore onto other block layouts: a field saved from ``dims=(2, 2, 2)``
  comes back on ``(4, 2, 1)`` and ``(1, 1, 1)`` through ``scatter(G)``
  bitwise, and an mgcg solve warm-started there from the restored global
  array needs fewer iterations than cold and agrees to 1e-6 relative;
* the leaf names of dicts, lists, tuples, 0-d tensors, NumPy arrays,
  Python numbers and ``Field``/``FieldSet`` trees are the reference's
  pytree paths, and a shape mismatch raises.
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
from repro_torch import ckpt  # noqa: E402
from repro_torch.apps import Poisson3D  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.fields import Field, FieldSet  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

REFERENCE = ALIAS + """
import json, os
jax.config.update("jax_enable_x64", True)
from repro.apps.poisson import Poisson3D
from repro.ckpt import checkpoint as ckpt
from repro.core import init_global_grid
from repro import fields

TMP = {tmp!r}
out = {{}}
# the mid-solve restart of tests/test_ckpt.py, its counts recorded
app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2))
grid = app.grid
u_half, info_half = app.solve("cg", tol=1e-3)
d = TMP + "/mid"
ckpt.save({{"u": u_half, "G": grid.gather(u_half)}}, step=1, ckpt_dir=d)
restored = ckpt.restore({{"u": jnp.zeros(grid.stacked_shape, jnp.float64),
                         "G": np.zeros(grid.global_shape)}}, 1, d)
x0 = grid.scatter(restored["G"])
u_cold, info_cold = app.solve("cg", tol=1e-9)
u_warm, info_warm = app.solve("cg", tol=1e-9, x0=x0)
out["half"], out["cold"], out["warm"] = (info_half.iterations, info_cold.iterations,
                                         info_warm.iterations)

# a file for the port: {{"G": gather(u), "iteration": 123}}
g = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=jnp.float64)
u = g.scatter(np.load(TMP + "/G.npy"))
ckpt.save({{"G": g.gather(u), "iteration": jnp.asarray(123)}}, step=4, ckpt_dir=TMP + "/ref")

# the leaf names of a nested tree with Fields
F = fields.FieldSet(vx=fields.zeros(g, "xface"), p=fields.zeros(g))
tree = {{"b": [jnp.zeros(2), (jnp.zeros(()), 3)], "a": F, "c": np.arange(3)}}
p = ckpt.save(tree, step=2, ckpt_dir=TMP + "/names")
out["names"] = json.load(open(os.path.join(p, "manifest.json")))["leaves"]
print(json.dumps(out))
"""

REFERENCE_READS = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.ckpt import checkpoint as ckpt
from repro.core import init_global_grid

TMP = {tmp!r}
g = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=jnp.float64)
assert ckpt.latest_step(TMP + "/port") == 9
back = ckpt.restore({{"G": np.zeros(g.global_shape), "iteration": jnp.asarray(0)}}, 9,
                    TMP + "/port")
np.testing.assert_array_equal(np.asarray(back["G"]), np.load(TMP + "/G.npy"))
np.testing.assert_array_equal(g.gather(g.scatter(back["G"])), np.load(TMP + "/G.npy"))
assert int(back["iteration"]) == 123
print("REF READ OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    np.save(f"{tmp}/G.npy", np.random.RandomState(5).rand(14, 10, 10))
    out = run(REFERENCE.format(tmp=tmp), ndev=8)
    return tmp, json.loads(out.strip().splitlines()[-1])


def test_grid_field_roundtrip(tmp_path):
    grid = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(0)
    G_u, G_r = rng.rand(*grid.global_shape), rng.rand(*grid.global_shape)
    state = {"u": grid.scatter(G_u), "r": grid.scatter(G_r), "iteration": torch.tensor(123)}
    path = ckpt.save(state, step=7, ckpt_dir=str(tmp_path))
    assert os.path.basename(path) == "step_00000007" and ckpt.latest_step(str(tmp_path)) == 7
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]   # atomic
    like = {"u": grid.zeros(), "r": grid.zeros(), "iteration": torch.tensor(0)}
    restored = ckpt.restore(like, 7, str(tmp_path))
    np.testing.assert_array_equal(grid.gather(restored["u"]), G_u)
    np.testing.assert_array_equal(grid.gather(restored["r"]), G_r)
    assert int(restored["iteration"]) == 123
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="ckpt"):
        ckpt.restore({"u": torch.zeros(3), "r": grid.zeros(), "iteration": torch.tensor(0)},
                     7, str(tmp_path))


def test_mid_solve_restart_resumes_exactly(reference, tmp_path):
    _, meta = reference
    app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    grid = app.grid
    u_half, info_half = app.solve("cg", tol=1e-3)
    ckpt.save({"u": u_half, "G": grid.gather(u_half)}, step=1, ckpt_dir=str(tmp_path))
    restored = ckpt.restore({"u": grid.zeros(), "G": np.zeros(grid.global_shape)}, 1,
                            str(tmp_path))
    assert torch.equal(restored["u"], u_half)
    x0 = grid.scatter(restored["G"].numpy())
    u_cold, info_cold = app.solve("cg", tol=1e-9)
    u_warm, info_warm = app.solve("cg", tol=1e-9, x0=x0)
    assert info_warm.converged and info_warm.iterations < info_cold.iterations
    a, b = grid.gather(u_warm), grid.gather(u_cold)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-6
    assert (info_half.iterations, info_cold.iterations, info_warm.iterations) \
        == (meta["half"], meta["cold"], meta["warm"])


def test_async_save_grid_field(tmp_path):
    grid = init_global_grid(6, 6, 6, dims=(2, 2, 2), device="cpu")
    G = np.arange(np.prod(grid.global_shape), dtype=np.float32).reshape(grid.global_shape)
    A = grid.scatter(G)
    fut = ckpt.async_save({"u": A}, step=3, ckpt_dir=str(tmp_path))
    A.fill_(-1.0)            # the host copy was taken before async_save returned
    fut.result(timeout=60)
    assert ckpt.latest_step(str(tmp_path)) == 3
    back = ckpt.restore({"u": grid.zeros()}, 3, str(tmp_path),
                        shardings={"u": torch.device("cpu")})
    np.testing.assert_array_equal(grid.gather(back["u"]), G)


def test_reference_file_restores_bitwise(reference):
    tmp, _ = reference
    assert ckpt.latest_step(f"{tmp}/ref") == 4
    back = ckpt.restore({"G": np.zeros((14, 10, 10)), "iteration": torch.tensor(0)}, 4,
                        f"{tmp}/ref")
    np.testing.assert_array_equal(back["G"].numpy(), np.load(f"{tmp}/G.npy"))
    assert back["iteration"].item() == 123 and back["iteration"].ndim == 0


def test_port_file_restores_bitwise_in_reference(reference):
    tmp, _ = reference
    g = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    u = g.scatter(np.load(f"{tmp}/G.npy"))
    ckpt.save({"G": g.gather(u), "iteration": 123}, step=9, ckpt_dir=f"{tmp}/port")
    assert "REF READ OK" in run(REFERENCE_READS.format(tmp=tmp), ndev=8)


def test_leaf_names_match_reference(reference, tmp_path):
    tmp, meta = reference
    g = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    F = FieldSet(vx=Field(g, g.zeros(), "xface"), p=Field(g, g.zeros()))
    tree = {"b": [torch.zeros(2), (torch.zeros(()), 3)], "a": F, "c": np.arange(3)}
    p = ckpt.save(tree, step=2, ckpt_dir=str(tmp_path))
    with open(os.path.join(p, "manifest.json")) as f:
        names = json.load(f)["leaves"]
    assert [n["name"] for n in names] == [n["name"] for n in meta["names"]]
    # a field is (*dims, *local) here and the stacked blocks there: same cells
    assert [int(np.prod(n["shape"])) for n in names] \
        == [int(np.prod(n["shape"])) for n in meta["names"]]
    back = ckpt.restore(tree, 2, str(tmp_path))
    assert isinstance(back["a"], FieldSet) and back["a"].vx.loc == "xface"
    assert isinstance(back["b"][1], tuple) and back["b"][1][1].item() == 3


@pytest.mark.parametrize("dims,local", [((4, 2, 1), (5, 6, 10)), ((1, 1, 1), (14, 10, 10))])
def test_restore_onto_other_layout(tmp_path, dims, local):
    g = init_global_grid(8, 6, 6, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    G = np.random.RandomState(6).rand(*g.global_shape)
    ckpt.save({"u": g.scatter(G), "G": g.gather(g.scatter(G))}, step=1, ckpt_dir=str(tmp_path))
    back = ckpt.restore({"u": g.zeros(), "G": np.zeros(g.global_shape)}, 1, str(tmp_path))
    g2 = init_global_grid(*local, dims=dims, dtype=torch.float64, device="cpu")
    assert g2.global_shape == g.global_shape
    u2 = g2.scatter(back["G"].numpy())
    np.testing.assert_array_equal(g2.gather(u2), G)
    np.testing.assert_array_equal(g2.gather(u2), g.gather(back["u"]))


@pytest.mark.parametrize("dims,n", [((4, 2, 1), (6, 10, 18)), ((1, 1, 1), (18, 18, 18))])
def test_warm_restart_on_other_layout(tmp_path, dims, n):
    """mgcg stopped at 1e-3 on 2x2x2 blocks, saved, resumed to 1e-8 on
    another layout of the same 18^3 global grid."""
    app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")
    u_half, _ = app.solve("mgcg", tol=1e-3)
    ckpt.save({"G": app.grid.gather(u_half)}, step=1, ckpt_dir=str(tmp_path))
    G = ckpt.restore({"G": np.zeros(app.grid.global_shape)}, 1, str(tmp_path))["G"].numpy()
    other = Poisson3D(nx=n[0], ny=n[1], nz=n[2], dims=dims, device="cpu")
    assert other.grid.global_shape == app.grid.global_shape
    u_cold, cold = other.solve("mgcg", tol=1e-8)
    u_warm, warm = other.solve("mgcg", tol=1e-8, x0=other.grid.scatter(G))
    assert warm.converged and warm.iterations < cold.iterations
    a, b = other.grid.gather(u_warm), other.grid.gather(u_cold)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-6
