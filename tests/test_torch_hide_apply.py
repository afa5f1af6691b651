"""The port's overlapped operator application (``core/hide.py::hide_apply``)
and FieldSet communication hiding (``fields/field.py::hide_step``).

* ``hide_apply(topo, op, u, *extra)`` equals ``op(update_halo(u), *extra)``
  (the reference's declared semantics, ``src/repro/core/hide.py:123``) for
  the center operator with and without a Helmholtz shift, on several block
  layouts, Dirichlet and periodic: bitwise on integer-valued f64 fields
  (every sum exact, as ``tests/test_hide_contracts.py`` does), to 1e-12 on
  random ones; ``u`` is not written.
* On ``dims=(2, 1, 1)`` (no exchange along a dim with one block and no
  wrap, the reference's skip branch) the result is bitwise equal to the
  reference's recompute loop without that skip and to the plain one; the
  operator runs once.
* ``hide_step`` equals ``update_halo(step(...))`` bitwise over a FieldSet,
  and raises if the step changes the FieldSet's structure.
* ``Poisson3D.solve(overlap=True)``: iteration counts EQUAL to the
  reference's (run once, in a module-scoped child process) and the
  solution within 1e-10 of its own non-overlapped solve; ``mg`` refuses
  ``overlap``.
* On the card (``cuda`` marker): one K2 launch per application, bitwise
  equal to the plain application, ``u`` untouched.
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
from repro_torch import fields  # noqa: E402
from repro_torch.apps import Poisson3D, TwoPhase3D  # noqa: E402
from repro_torch.core import hide_apply, init_global_grid, update_halo  # noqa: E402
from repro_torch.fields import Field, FieldSet  # noqa: E402
from repro_torch.kernels.solver3d import kernel as sk  # noqa: E402
from repro_torch.kernels.solver3d.ref import poisson_stencil  # noqa: E402
from repro_torch.solvers import poisson_apply  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
SP = (0.3, 0.2, 0.1)
# name: dims, local extents, periodic
LAYOUTS = {
    "2x2x2": ((2, 2, 2), (10, 9, 8), (False, False, False)),
    "4x2x1": ((4, 2, 1), (10, 9, 8), (False, False, False)),
    "periodic_ttf": ((2, 2, 2), (10, 10, 10), (True, True, False)),
    "1x1x1_periodic": ((1, 1, 1), (8, 8, 8), (True, False, True)),
}
POISSON = ("cg", "pipecg", "mgcg", "pt")


def _op(spacing, shifted):
    if shifted:
        return lambda u, c, s: poisson_stencil(u, c, spacing, s)
    return lambda u, c: poisson_stencil(u, c, spacing)


def _fields(g, integer: bool, seed: int):
    rng = np.random.RandomState(seed)

    def one(scale, offset):
        v = rng.rand(*g.global_shape)
        return g.scatter(np.round(v * scale) + offset if integer else v * scale + offset)

    # integer-valued: every product and sum below is exact in f64
    return one(64, 0), one(8, 1), one(8, 1)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hide_apply_equals_op_of_update_halo(layout, integer, shifted):
    dims, local, per = LAYOUTS[layout]
    g = init_global_grid(*local, dims=dims, periodic=per, dtype=torch.float64, device="cpu")
    u, c, s = _fields(g, integer, seed=1)
    spacing = (1.0, 1.0, 1.0) if integer else SP
    extra = (c, s) if shifted else (c,)
    u0 = u.clone()
    got = hide_apply(g.topo, _op(spacing, shifted), u, *extra)
    assert torch.equal(u, u0)                # u is read only
    want = _op(spacing, shifted)(update_halo(g.topo, u.clone()), *extra)
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _hide_apply_noskip(topo, op_fn, u, *extra, h=1):
    """The reference's recompute loop WITHOUT the skip of a dim that has one
    block and no wrap (``tests/test_hide_contracts.py``), on the port's
    fields: every dim's shells recomputed from the halo-updated input."""
    nd = topo.ndims
    u2 = update_halo(topo, u.clone(), width=h)
    out = op_fn(u, *extra)
    for d in range(nd):
        ax, n = nd + d, u.shape[nd + d]
        lo = op_fn(u2.narrow(ax, 0, 3 * h), *(e.narrow(ax, 0, 3 * h) for e in extra))
        hi = op_fn(u2.narrow(ax, n - 3 * h, 3 * h), *(e.narrow(ax, n - 3 * h, 3 * h)
                                                       for e in extra))
        out.narrow(ax, h, h).copy_(lo.narrow(ax, h, h))
        out.narrow(ax, n - 2 * h, h).copy_(hi.narrow(ax, h, h))
    return out


def test_skip_branch_bitwise():
    g = init_global_grid(12, 10, 10, dims=(2, 1, 1), dtype=torch.float64, device="cpu")
    u, c, _ = _fields(g, integer=True, seed=7)
    op = _op((1.0, 1.0, 1.0), False)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return op(*args)

    skipped = hide_apply(g.topo, counted, u, c)
    assert len(calls) == 1        # once, on a halo-updated copy of u
    unskipped = _hide_apply_noskip(g.topo, op, u, c)
    plain = op(update_halo(g.topo, u.clone()), c)
    assert torch.equal(skipped, unskipped)
    assert torch.equal(skipped, plain)


def test_hide_apply_rejects_what_it_does_not_take():
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    u = g.ones()
    with pytest.raises(ValueError, match="rank"):
        hide_apply(g.topo, lambda x: x, u[0])
    small = init_global_grid(10, 10, 3, dims=(2, 2, 1), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="too large"):
        hide_apply(small.topo, lambda x: x, small.ones(), halo=5)
    with pytest.raises(ValueError, match="already includes"):
        poisson_apply(g, u, u, SP, update_halo=False, hide=True)


@pytest.mark.parametrize("per", [(False, False, False), (True, True, False)])
def test_hide_step_equals_update_halo_of_step(per):
    app = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=per, hide=None,
                     device="cpu")
    g = app.grid
    S, _ = app.run(2)             # a state that has moved off its start

    def fstep(S):
        Pe2, phi2 = app._single_step(S.Pe.data, S.phi.data)
        return FieldSet(Pe=S.Pe.with_data(Pe2), phi=S.phi.with_data(phi2))

    got = fields.hide_step(g, fstep, S, width=(2, 2, 2))
    want = fields.update_halo(g, fstep(S))
    assert list(got.keys()) == ["Pe", "phi"]
    for k in ("Pe", "phi"):
        assert got[k].loc == "center" and torch.equal(got[k].data, want[k].data), k

    def renamed(S):
        return FieldSet(P=S.Pe, phi=S.phi)

    def moved(S):
        return FieldSet(Pe=Field(g, S.Pe.data, "xface"), phi=S.phi)

    for bad in (renamed, moved, lambda S: (S.Pe, S.phi)):
        with pytest.raises(ValueError, match="structure"):
            fields.hide_step(g, bad, S, width=(2, 2, 2))


REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.apps.poisson import Poisson3D

app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2))
out = {{}}
for method in {methods!r}:
    u, info = app.solve(method, tol=1e-8, overlap=True)
    out[method] = dict(iterations=info.iterations, relres=info.relres)
json.dump(out, open({tmp!r} + "/overlap.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hide_apply")
    run(REFERENCE.format(tmp=str(tmp), methods=POISSON), ndev=8, timeout=900)
    return json.loads((tmp / "overlap.json").read_text())


@pytest.fixture(scope="module")
def poisson():
    return Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), device="cpu")


@pytest.mark.parametrize("method", POISSON)
def test_poisson_overlap_counts_equal_reference(reference, poisson, method):
    u, info = poisson.solve(method, tol=1e-8, overlap=True)
    assert info.iterations == reference[method]["iterations"]
    assert info.converged
    u_plain, plain = poisson.solve(method, tol=1e-8)
    assert plain.iterations == info.iterations
    err = np.abs(poisson.grid.gather(u) - poisson.grid.gather(u_plain)).max()
    assert err <= 1e-10 * np.abs(poisson.grid.gather(u_plain)).max(), err
    with pytest.raises(ValueError, match="overlap"):
        poisson.solve("mg", overlap=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hide_apply_on_card(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dims, local, per = LAYOUTS[layout]
    g = init_global_grid(*local, dims=dims, periodic=per, dtype=torch.float64)
    u, c, s = _fields(g, integer=False, seed=3)
    u0 = u.clone()
    for shift in (None, s):
        n0 = sk.apply_cuda.launches
        got = poisson_apply(g, u, c, SP, hide=True, shift=shift)
        torch.cuda.synchronize()
        exchanged = sum(1 for d in range(3) if dims[d] > 1 or per[d])
        assert sk.apply_cuda.launches - n0 == 1
        assert torch.equal(u, u0)
        want = poisson_apply(g, u.clone(), c, SP, shift=shift)
        assert torch.equal(got, want)
        ref_ = poisson_apply(g, u.clone(), c, SP, shift=shift, use_kernel="ref")
        torch.testing.assert_close(got, ref_, rtol=1e-12, atol=1e-12 * ref_.abs().max().item())
