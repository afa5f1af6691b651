"""The port's masks and global reductions against the JAX package.

Masks (ownership, unknowns, location-aware validity) are compared bitwise
with the reference's on 1-D, 2-D and 3-D grids, Dirichlet, periodic and
mixed.  Reductions use integer-valued payloads, as
``tests/test_periodic_solvers.py`` does, so every f64 sum is exact: ``dot``,
the norms, ``field_min``/``field_max``, ``masked_mean`` and
``tree_dot_many`` must EQUAL the reference's values, and be bitwise equal
between 8 blocks and one block covering the same global grid.  The
reference runs once in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npy`` files made from a numpy seed.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.core import init_global_grid, locations  # noqa: E402
from repro_torch.solvers import reductions as red  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# name: local shape, dims, periodic
MASK_CASES = {
    "1d": ((10,), (8,), (False,)),
    "1d_periodic": ((10,), (8,), (True,)),
    "2d": ((8, 6), (4, 2), (False, False)),
    "2d_mixed": ((8, 7), (2, 4), (False, True)),
    "3d": ((8, 6, 6), (2, 2, 2), (False, False, False)),
    "3d_periodic": ((8, 6, 6), (2, 2, 2), (True, True, True)),
    "3d_mixed": ((8, 6, 6), (2, 2, 2), (True, False, True)),
    "3d_421": ((7, 6, 8), (4, 2, 1), (False, True, False)),
}
MASKS = ("owned", "interior", "solve", "loc_center", "loc_xface", "loc_yface", "loc_zface",
         "valid_xface", "interior_xface", "interior_zface")
PERIODIC = [(True, True, True), (True, False, True), (False, True, False),
            (False, False, False)]

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid, locations as L
from repro.core.topology import make_grid_mesh
from repro import solvers
from repro.solvers import reductions as red

TMP = {tmp!r}
cases = json.load(open(TMP + "/mask_cases.json"))

def field(g, fn):
    sm = jax.shard_map(fn, mesh=g.mesh, in_specs=(), out_specs=g.spec, check_vma=False)
    return np.asarray(jax.jit(sm)())

for name, (local, dims, per) in cases.items():
    g = init_global_grid(*(list(local) + [None] * (3 - len(local))), dims=tuple(dims),
                         periodic=tuple(per), dtype=jnp.float64)
    fns = {{"owned": lambda: red.owned_mask(g), "interior": lambda: red.interior_mask(g),
           "solve": lambda: red.solve_mask(g)}}
    if len(local) == 3:
        for loc in ("center", "xface", "yface", "zface"):
            fns["loc_" + loc] = lambda loc=loc: red.loc_solve_mask(g, loc)
        fns["valid_xface"] = lambda: L.valid_mask(g, "xface")
        fns["interior_xface"] = lambda: L.interior_mask(g, "xface")
        fns["interior_zface"] = lambda: L.interior_mask(g, "zface")
    for k, fn in fns.items():
        np.save(f"{{TMP}}/mask_{{name}}_{{k}}.npy", field(g, fn))

out = {{}}
mesh1 = make_grid_mesh(3, dims=(1, 1, 1), devices=jax.devices()[:1])
for i, per in enumerate({periodic!r}):
    GA = np.load(f"{{TMP}}/GA{{i}}.npy")
    GB = np.load(f"{{TMP}}/GB{{i}}.npy")
    for ranks in ("8", "1"):
        if ranks == "8":
            g = init_global_grid(8, 6, 6, dims=(2, 2, 2), periodic=tuple(per), dtype=jnp.float64)
        else:
            g = init_global_grid(14, 10, 10, mesh=mesh1, periodic=tuple(per), dtype=jnp.float64)
        for dt in ("float64", "float32"):
            A = g.scatter(GA).astype(dt)
            B = g.scatter(GB).astype(dt)
            def many(a, b):
                m = red.solve_mask(g, a.dtype)
                return jnp.stack(red.tree_dot_many(g, [(a, b), (a, a), (b, b)], m))
            def mean(a):
                return red.masked_mean(g, a, red.solve_mask(g, a.dtype))
            vals = dict(
                dot=solvers.dot_g(g, A, B), norm_l2=solvers.norm_l2_g(g, A),
                norm_linf=solvers.norm_linf_g(g, A), field_min=solvers.field_min_g(g, A),
                field_max=solvers.field_max_g(g, A),
                masked_mean=red.host_reduce(g, mean, A),
                many=red.host_reduce(g, many, A, B))
            out[f"{{i}}_{{ranks}}_{{dt}}"] = {{k: np.asarray(v, np.float64).tolist()
                                           for k, v in vals.items()}}
json.dump(out, open(TMP + "/values.json", "w"))
print("OK")
"""


def _payloads():
    rng = np.random.RandomState(0)
    out = []
    for _ in PERIODIC:
        shape = (14, 10, 10)   # global shape of (8, 6, 6) local on (2, 2, 2)
        out.append((rng.randint(-50, 50, shape).astype(np.float64),
                    rng.randint(-50, 50, shape).astype(np.float64)))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_reductions")
    (tmp / "mask_cases.json").write_text(json.dumps(MASK_CASES))
    for i, (GA, GB) in enumerate(_payloads()):
        np.save(tmp / f"GA{i}.npy", GA)
        np.save(tmp / f"GB{i}.npy", GB)
    run(REFERENCE.format(tmp=str(tmp), periodic=PERIODIC), ndev=8)
    return tmp, json.loads((tmp / "values.json").read_text())


def _grid(local, dims, per, dtype=torch.float64):
    return init_global_grid(*(list(local) + [None] * (3 - len(local))), dims=dims,
                            periodic=per, dtype=dtype, device="cpu")


def _port_masks(g):
    out = {"owned": red.owned_mask(g), "interior": red.interior_mask(g),
           "solve": red.solve_mask(g)}
    if g.ndims == 3:
        for loc in locations.LOCATIONS:
            out["loc_" + loc] = red.loc_solve_mask(g, loc)
        out["valid_xface"] = locations.valid_mask(g, "xface")
        out["interior_xface"] = locations.interior_mask(g, "xface")
        out["interior_zface"] = locations.interior_mask(g, "zface")
    return out


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_masks_equal_reference(reference, name):
    tmp, _ = reference
    g = _grid(*MASK_CASES[name])
    masks = _port_masks(g)
    assert sorted(masks) == sorted(MASKS if g.ndims == 3 else MASKS[:3])
    for k, m in masks.items():
        assert m.shape == g.shape and m.dtype == torch.float64, k
        want = np.load(tmp / f"mask_{name}_{k}.npy")
        np.testing.assert_array_equal(g.to_stacked(m), want, err_msg=k)


def _port_values(g, GA, GB, dtype):
    A, B = g.scatter(GA, dtype=dtype), g.scatter(GB, dtype=dtype)
    m = red.solve_mask(g, dtype)
    return dict(
        dot=solvers.dot_g(g, A, B), norm_l2=solvers.norm_l2_g(g, A),
        norm_linf=solvers.norm_linf_g(g, A), field_min=solvers.field_min_g(g, A),
        field_max=solvers.field_max_g(g, A),
        masked_mean=red.host_reduce(g, lambda a: red.masked_mean(g, a, m), A),
        many=torch.stack(red.tree_dot_many(g, [(A, B), (A, A), (B, B)], m)))


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("i", range(len(PERIODIC)))
def test_reductions_exact_and_equal_on_1_and_8_blocks(reference, i, dt):
    _, ref = reference
    GA, GB = _payloads()[i]
    per = PERIODIC[i]
    dtype = getattr(torch, dt)
    got = {}
    for ranks, (local, dims) in {"8": ((8, 6, 6), (2, 2, 2)),
                                 "1": ((14, 10, 10), (1, 1, 1))}.items():
        g = _grid(local, dims, per)
        assert g.global_shape == GA.shape
        vals = _port_values(g, GA, GB, dtype)
        for k, v in vals.items():
            # f32 fields accumulate in f64, except min/max/linf, which stay in the field type
            if k in ("dot", "norm_l2", "masked_mean", "many"):
                assert v.dtype == torch.float64, k
            assert v.tolist() == ref[f"{i}_{ranks}_{dt}"][k], (ranks, k)
        got[ranks] = {k: v.tolist() for k, v in vals.items()}
    assert got["8"] == got["1"]
    # == NumPy on the unique cells: ring planes of periodic dims are duplicates,
    # the Dirichlet ring is not an unknown of the solve mask
    sl = tuple(slice(1, -1) if p else slice(None) for p in per)
    assert got["8"]["dot"] == (GA[sl] * GB[sl]).sum()
    inner = (slice(1, -1),) * 3
    assert got["8"]["many"][1] == (GA[inner] ** 2).sum()
    assert got["8"]["field_max"] == GA[sl].max() and got["8"]["field_min"] == GA[sl].min()


def test_acc_dtype_and_reduction_contracts():
    assert red.acc_dtype(torch.float32) == torch.float64
    assert red.acc_dtype(torch.float64) == torch.float64
    assert red.acc_dtype(torch.int32) == torch.int32
    g = _grid((8, 6, 6), (2, 2, 2), (False, False, False), dtype=torch.float32)
    z = g.zeros()
    m = red.solve_mask(g)
    assert float(red.rhs_norm(g, z, m)) == 1.0            # zero rhs: absolute residuals
    assert float(red.tree_rhs_norm(g, [z, g.ones()], [m, m])) == math.sqrt(float(m.sum()))
    with pytest.raises(ValueError, match="mismatched"):
        red.tree_dot(g, [z, z], [z], [m, m])
    with pytest.raises(ValueError, match="mismatched"):
        red.tree_dot_many(g, [([z, z], [z, z]), (z, z)], [m, m])
    # owned cells tile the global grid exactly
    assert int(red.owned_mask(g).sum()) == math.prod(g.global_shape)
    assert int(m.sum()) == math.prod(n - 2 for n in g.global_shape)
