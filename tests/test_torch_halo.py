"""The port's ``update_halo`` and ``hide_communication`` against the JAX package.

Every case runs the reference once, in one module-scoped child process with
8 fake CPU devices (``_mp.run``); inputs and outputs travel as ``.npy``
files made from a numpy seed.  The port runs on ``device="cpu"``.  Halo
results must be BITWISE equal: the exchange only copies values.  The hide
cases use an integer-valued step (every sum exact), so bitwise equality
tests the boundary/interior split and not the rounding of one framework.
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
from repro_torch.core import hide_communication, init_global_grid, update_halo  # noqa: E402

# The reference needs this alias on jax 0.9; it is set only in the child.
ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# name: local shape, dims, periodic, halo width, grid dims to update (None: all)
HALO_CASES = {
    "1d": ((10,), (8,), (False,), 1, None),
    "1d_periodic_w2": ((10,), (8,), (True,), 2, None),
    "2d": ((8, 6), (4, 2), (False, False), 1, None),
    "2d_periodic_mix": ((8, 7), (2, 4), (False, True), 1, None),
    "3d": ((6, 7, 8), (2, 2, 2), (False, False, False), 1, None),
    "3d_w2": ((10, 9, 8), (2, 2, 2), (False, False, False), 2, None),
    "3d_periodic_mix": ((6, 7, 8), (2, 2, 2), (True, False, True), 1, None),
    "3d_periodic_w2_421": ((9, 8, 7), (4, 2, 1), (True, True, True), 2, None),
    "3d_one_block_dims": ((6, 7, 8), (8, 1, 1), (False, True, False), 1, None),
    "3d_single_rank": ((6, 7, 8), (1, 1, 1), (False, False, True), 1, None),
    "3d_dims_subset": ((6, 7, 8), (2, 2, 2), (False, False, False), 1, (0, 2)),
}

# name: local shape, dims, periodic, halo width, shell width
HIDE_CASES = {
    "222": ((12, 10, 14), (2, 2, 2), (False, False, False), 1, (3, 2, 2)),
    "222_periodic_mix": ((10, 10, 10), (2, 2, 2), (True, False, True), 1, (2, 2, 2)),
    "222_clamped": ((8, 8, 8), (2, 2, 2), (False, False, False), 1, (0, 0, 0)),
    "222_w2": ((14, 12, 12), (2, 2, 2), (False, False, False), 2, (4, 2, 2)),
    "421": ((10, 10, 10), (4, 2, 1), (False, False, False), 1, (2, 2, 2)),
    "811_one_block_periodic": ((10, 10, 10), (8, 1, 1), (False, True, False), 1, (2, 2, 2)),
}

REFERENCE = ALIAS + """
import json, math
from repro.core import init_global_grid
from repro.core.topology import make_grid_mesh

TMP = {tmp!r}
halo_cases = json.load(open(TMP + "/halo_cases.json"))
hide_cases = json.load(open(TMP + "/hide_cases.json"))

def grid(local, dims, periodic, width):
    kw = dict(dims=tuple(dims), periodic=tuple(periodic), overlap=2 * width)
    if math.prod(dims) < 8:
        kw["mesh"] = make_grid_mesh(len(local), dims=tuple(dims),
                                    devices=jax.devices()[:math.prod(dims)])
    return init_global_grid(*(list(local) + [None] * (3 - len(local))), **kw)

for name, (local, dims, periodic, width, only) in halo_cases.items():
    g = grid(local, dims, periodic, width)
    A = jnp.asarray(np.load(f"{{TMP}}/halo_{{name}}_in.npy"))
    if only is None:
        out = g.update_halo_g(A)
    else:
        out = g.parallel(lambda a: g.update_halo(a, dims=tuple(only)))(A)
    np.save(f"{{TMP}}/halo_{{name}}_out.npy", np.asarray(out))

def step(T, Ci, r):
    i = tuple(slice(r, n - r) for n in T.shape)
    def sh(d, k):
        return tuple(slice(r + k, n - r + k) if e == d else i[e]
                     for e, n in enumerate(T.shape))
    s = sum(T[sh(d, k)] for d in range(3) for k in (1, -1))
    Tn = T.at[i].set(T[i] * Ci[i] + s)
    Cn = Ci.at[i].add(1.0)
    return Tn, Cn

for name, (local, dims, periodic, width, shell) in hide_cases.items():
    g = grid(local, dims, periodic, width)
    T = jnp.asarray(np.load(f"{{TMP}}/hide_{{name}}_T.npy"))
    Ci = jnp.asarray(np.load(f"{{TMP}}/hide_{{name}}_Ci.npy"))
    f = g.parallel(lambda T, Ci: g.hide(lambda a, b: step(a, b, width), (T, Ci),
                                        width=tuple(shell)))
    Tn, Cn = f(T, Ci)
    np.save(f"{{TMP}}/hide_{{name}}_Tout.npy", np.asarray(Tn))
    np.save(f"{{TMP}}/hide_{{name}}_Cout.npy", np.asarray(Cn))
print("OK")
"""


def _stacked(local, dims):
    return tuple(d * n for d, n in zip(dims, local))


def _step(T, Ci, r=1):
    """Integer-valued radius-1 step on the trailing three axes, written on
    ``[r, n-r)``: the ring of width ``r`` (the halo width) passes through."""
    i = (Ellipsis,) + tuple(slice(r, n - r) for n in T.shape[-3:])

    def sh(d, k):
        return (Ellipsis,) + tuple(slice(r + k, n - r + k) if e == d else i[1 + e]
                                   for e, n in enumerate(T.shape[-3:]))

    s = sum(T[sh(d, k)] for d in range(3) for k in (1, -1))
    Tn = T.clone()
    Tn[i] = T[i] * Ci[i] + s
    Cn = Ci.clone()
    Cn[i] += 1.0
    return Tn, Cn


def _grid(local, dims, periodic, width, device="cpu"):
    loc = list(local) + [None] * (3 - len(local))
    return init_global_grid(*loc, dims=dims, periodic=periodic, overlap=2 * width,
                            device=device)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_halo")
    rng = np.random.RandomState(0)
    inputs = {}
    for name, (local, dims, *_rest) in HALO_CASES.items():
        a = rng.rand(*_stacked(local, dims)).astype(np.float32)
        np.save(tmp / f"halo_{name}_in.npy", a)
        inputs[("halo", name)] = a
    for name, (local, dims, *_rest) in HIDE_CASES.items():
        shape = _stacked(local, dims)
        T = rng.randint(0, 8, shape).astype(np.float32)
        Ci = rng.randint(0, 3, shape).astype(np.float32)
        np.save(tmp / f"hide_{name}_T.npy", T)
        np.save(tmp / f"hide_{name}_Ci.npy", Ci)
        inputs[("hide", name)] = (T, Ci)
    (tmp / "halo_cases.json").write_text(json.dumps(HALO_CASES))
    (tmp / "hide_cases.json").write_text(json.dumps(HIDE_CASES))
    run(REFERENCE.format(tmp=str(tmp)), ndev=8)
    return tmp, inputs


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_update_halo_bitwise_vs_jax(reference, name):
    tmp, inputs = reference
    local, dims, periodic, width, only = HALO_CASES[name]
    g = _grid(local, dims, periodic, width)
    A = g.from_stacked(inputs[("halo", name)])
    out = update_halo(g.topo, A, width=width, dims=only)
    assert out is A  # in place
    np.testing.assert_array_equal(g.to_stacked(out), np.load(tmp / f"halo_{name}_out.npy"))


@pytest.mark.parametrize("name", list(HIDE_CASES))
def test_hide_bitwise_vs_jax_and_plain(reference, name):
    tmp, inputs = reference
    local, dims, periodic, width, shell = HIDE_CASES[name]
    g = _grid(local, dims, periodic, width)
    T0, C0 = inputs[("hide", name)]
    T, Ci = g.from_stacked(T0), g.from_stacked(C0)
    def step(T, Ci):
        return _step(T, Ci, width)

    Tn, Cn = g.hide(step, (T, Ci), width=shell)
    # the inputs are untouched
    np.testing.assert_array_equal(g.to_stacked(T), T0)
    # == the JAX package's grid.hide
    np.testing.assert_array_equal(g.to_stacked(Tn), np.load(tmp / f"hide_{name}_Tout.npy"))
    np.testing.assert_array_equal(g.to_stacked(Cn), np.load(tmp / f"hide_{name}_Cout.npy"))
    # == the port's own update_halo(step(...))
    Pn, Pc = g.update_halo(*step(T, Ci))
    assert torch.equal(Tn, Pn) and torch.equal(Cn, Pc)


def test_hide_heat_step_bitwise_vs_update_halo():
    from repro_torch.kernels.stencil3d import heat_step

    g = init_global_grid(16, 14, 12, dims=(2, 2, 2), device="cpu")
    rng = np.random.RandomState(3)
    T = g.scatter(1.0 + rng.rand(*g.global_shape))
    Ci = g.scatter(0.5 + rng.rand(*g.global_shape))

    def step(T, Ci):
        return heat_step(T, Ci, 1.0, 1e-3, 0.1, 0.1, 0.1)

    got = g.hide(step, (T, Ci), width=(4, 2, 2))
    assert torch.equal(got, g.update_halo(step(T, Ci)))


def test_hide_rejects_bad_inputs():
    g = init_global_grid(8, 8, 8, dims=(2, 2, 2), device="cpu")
    T = g.zeros()
    with pytest.raises(ValueError, match="too small"):
        hide_communication(g.topo, lambda T: T, (T,), width=(4, 2, 2), halo=1)
    with pytest.raises(ValueError, match="rank"):
        hide_communication(g.topo, lambda T: T, (T[0],), width=2, halo=1)


def test_update_halo_argument_checks():
    g = init_global_grid(8, 8, 8, dims=(2, 2, 2), device="cpu")
    T = g.zeros()
    with pytest.raises(ValueError, match="location"):
        update_halo(g.topo, T, locations=("cornerface",))
    with pytest.raises(ValueError, match="locations"):
        update_halo(g.topo, T, T, locations=("center",))
    with pytest.raises(ValueError, match="not a field"):
        update_halo(g.topo, T[0])
    with pytest.raises(ValueError, match="too large"):
        update_halo(g.topo, T, width=4)
    # staggered locations exchange like centers; leading axes are a batch
    a = torch.rand((3,) + g.shape)
    b = a.clone()
    update_halo(g.topo, a, width=1, locations=("xface",))
    for i in range(3):
        update_halo(g.topo, b[i], width=1)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_hide_on_streams_bitwise_on_card(cuda_device):
    """The side-stream exchange overlapping the interior gives the same bits
    as update_halo(step) on the card."""
    from repro_torch.kernels.stencil3d import heat_step

    g = init_global_grid(40, 36, 34, dims=(2, 2, 2), device=cuda_device)
    rng = np.random.RandomState(5)
    T = g.scatter(1.0 + rng.rand(*g.global_shape))
    Ci = g.scatter(0.5 + rng.rand(*g.global_shape))

    def step(T, Ci):
        return heat_step(T, Ci, 1.0, 1e-3, 0.1, 0.1, 0.1)

    for _ in range(3):
        got = g.hide(step, (T, Ci), width=(8, 2, 2))
        want = g.update_halo(step(T, Ci))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        T = got


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
