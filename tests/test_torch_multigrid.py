"""The port's multigrid (hierarchy, transfers, coefficients, V-cycle)
against the JAX package's ``solvers/multigrid.py`` and ``transfers.py``.

* ``hierarchy`` shapes and ``level_spacings`` equal the reference's;
* ``restrict``, ``prolong``, ``coarsen_coefficient`` and ``poisson_apply``
  (with and without a Helmholtz shift) on seeded local arrays, f64, to
  1e-14 (rtol = atol: the same expressions, rounded alike except for the
  order of a few sums);
* ``build_coefficients`` and one V-cycle application (Jacobi and
  Chebyshev, Dirichlet and all-periodic, with and without a per-level
  Helmholtz shift) from a seeded rhs, with the cycle's residual, on 8
  blocks and on one block of the same 18^3 global grid, f64, to 1e-12
  relative to the field's largest value.

The reference runs once in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npy`` files made from a numpy seed.
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
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.solver3d import kernel as sk  # noqa: E402
from repro_torch.solvers import multigrid as mg  # noqa: E402
from repro_torch.solvers import transfers  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# name: local extents (None drops a dim), overlap
HIERARCHY_CASES = {
    "10": ((10, 10, 10), 2), "2d": ((10, 10, None), 2), "odd": ((10, 9, 10), 2),
    "ovl4": ((12, 12, 12), 4), "mixed": ((18, 10, 34), 2), "514": ((514, 514, 514), 2),
}
SP = (0.5, 0.7, 1.1)
LOCAL = (10, 6, 8)
# name: dims, local extent, periodic, smoother, shifted (per-level shifts
# coarsened from one seeded field, as the coefficients are)
CYCLES = {
    "8_jacobi": ((2, 2, 2), 10, False, "jacobi", False),
    "1_jacobi": ((1, 1, 1), 18, False, "jacobi", False),
    "8_chebyshev": ((2, 2, 2), 10, False, "chebyshev", False),
    "1_chebyshev": ((1, 1, 1), 18, False, "chebyshev", False),
    "8_jacobi_periodic": ((2, 2, 2), 10, True, "jacobi", False),
    "1_chebyshev_periodic": ((1, 1, 1), 18, True, "chebyshev", False),
    "8_jacobi_shift": ((2, 2, 2), 10, False, "jacobi", True),
    "1_chebyshev_shift": ((1, 1, 1), 18, False, "chebyshev", True),
    "8_chebyshev_periodic_shift": ((2, 2, 2), 10, True, "chebyshev", True),
}
SPACING = (1 / 17, 1 / 17, 1 / 17)

REFERENCE = ALIAS + """
import json
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid
from repro.core.topology import make_grid_mesh
from repro.solvers import multigrid as mg, transfers

TMP = {tmp!r}
out = {{}}
for name, (local, ovl) in {hier!r}.items():
    g = init_global_grid(*local, overlap=ovl, dims=(1,) * sum(n is not None for n in local),
                         mesh=make_grid_mesh(sum(n is not None for n in local),
                                             dims=(1,) * sum(n is not None for n in local),
                                             devices=jax.devices()[:1]))
    grids = g.hierarchy()
    out[name] = dict(local=[list(x.local_shape) for x in grids],
                     glob=[list(x.global_shape) for x in grids],
                     can=[x.can_coarsen() for x in grids],
                     h=[list(h) for h in mg.level_spacings(g, grids, (0.1, 0.2, 0.3)[:g.ndims])])
json.dump(out, open(TMP + "/hierarchy.json", "w"))

a, c, s = (jnp.asarray(np.load(f"{{TMP}}/{{n}}.npy")) for n in "acs")
np.save(TMP + "/restrict.npy", np.asarray(transfers.restrict(a)))
np.save(TMP + "/prolong.npy", np.asarray(transfers.prolong(a)))
np.save(TMP + "/coarsen.npy", np.asarray(transfers.coarsen_coefficient(c)))
np.save(TMP + "/apply.npy", np.asarray(mg.poisson_apply(None, a, c, {sp!r}, update_halo=False)))
np.save(TMP + "/apply_shift.npy", np.asarray(
    mg.poisson_apply(None, a, c, {sp!r}, update_halo=False, shift=s)))

mesh1 = make_grid_mesh(3, dims=(1, 1, 1), devices=jax.devices()[:1])
for name, (dims, n, per, smoother, shifted) in {cycles!r}.items():
    kw = dict(mesh=mesh1) if dims == (1, 1, 1) else dict(dims=dims)
    g = init_global_grid(n, n, n, periodic=(per,) * 3, dtype=jnp.float64, **kw)
    grids = g.hierarchy()
    hs = mg.level_spacings(g, grids, {spacing!r})
    C = g.scatter(np.load(f"{{TMP}}/C_{{per}}.npy"))
    F = g.scatter(np.load(f"{{TMP}}/F_{{per}}.npy"))
    S = g.scatter(np.load(f"{{TMP}}/S_{{per}}.npy"))

    def local(c, f, s):
        cs = mg.build_coefficients(g, grids, c)
        ss = mg.build_coefficients(g, grids, s) if shifted else None
        v_cycle, residual = mg.make_v_cycle(g, grids, hs, cs, shifts=ss, smoother=smoother)
        u = v_cycle(0, jnp.zeros_like(f), f)
        return (u, residual(0, u, f)) + tuple(cs)

    sm = jax.shard_map(local, mesh=g.mesh, in_specs=(g.spec, g.spec, g.spec),
                       out_specs=tuple(g.spec for _ in range(2 + len(grids))), check_vma=False)
    outs = jax.jit(sm)(C, F, S)
    for k, o in enumerate(outs):
        np.save(f"{{TMP}}/cycle_{{name}}_{{k}}.npy", np.asarray(o))
print("OK")
"""


def _wrap(G, per):
    """The global array made wrap-consistent (ring == opposite interior) if
    ``per``, else unchanged."""
    G = G.copy()
    for d in range(3 if per else 0):
        lo, hi = [slice(None)] * 3, [slice(None)] * 3
        lo[d], hi[d] = 0, -2
        G[tuple(lo)] = G[tuple(hi)]
        lo[d], hi[d] = -1, 1
        G[tuple(lo)] = G[tuple(hi)]
    return G


def _global_fields():
    rng = np.random.RandomState(3)
    out = {}
    for per in (False, True):
        C = _wrap(1.0 + 0.5 * rng.rand(18, 18, 18), per)
        F = rng.rand(18, 18, 18) - 0.5
        if not per:
            F[[0, -1]] = 0.0
            F[:, [0, -1]] = 0.0
            F[:, :, [0, -1]] = 0.0
        out[per] = (C, _wrap(F, per))
    return out


def _shift_field(per):
    """A seeded positive Helmholtz shift of the same order as the
    operator's diagonal on the 18^3 grid (wrap-consistent if ``per``)."""
    rng = np.random.RandomState(4)
    return _wrap(100.0 + 500.0 * rng.rand(18, 18, 18), per)


def _locals():
    rng = np.random.RandomState(2)
    return {n: rng.rand(*LOCAL) + (0.5 if n == "c" else 0.0) for n in "acs"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multigrid")
    for n, v in _locals().items():
        np.save(tmp / f"{n}.npy", v)
    for per, (C, F) in _global_fields().items():
        np.save(tmp / f"C_{per}.npy", C)
        np.save(tmp / f"F_{per}.npy", F)
        np.save(tmp / f"S_{per}.npy", _shift_field(per))
    run(REFERENCE.format(tmp=str(tmp), hier=HIERARCHY_CASES, sp=SP, cycles=CYCLES,
                         spacing=SPACING), ndev=8)
    return tmp, json.loads((tmp / "hierarchy.json").read_text())


@pytest.mark.parametrize("name", list(HIERARCHY_CASES))
def test_hierarchy_and_level_spacings(reference, name):
    _, ref = reference
    local, ovl = HIERARCHY_CASES[name]
    nd = sum(n is not None for n in local)
    g = init_global_grid(*local, overlap=ovl, dims=(1,) * nd, dtype=torch.float64, device="cpu")
    grids = g.hierarchy()
    want = ref[name]
    assert [list(x.local_shape) for x in grids] == want["local"]
    assert [list(x.global_shape) for x in grids] == want["glob"]
    assert [x.can_coarsen() for x in grids] == want["can"]
    assert [list(h) for h in mg.level_spacings(g, grids, (0.1, 0.2, 0.3)[:nd])] == want["h"]
    for x in grids:
        assert (x.dims, x.topo.periodic, x.halo, x.dtype, x.device) == \
            (g.dims, g.topo.periodic, g.halo, g.dtype, g.device)
    if not g.can_coarsen():
        with pytest.raises(ValueError):
            g.coarsen()
    assert len(g.hierarchy(max_levels=1)) == 1


def test_transfers_and_operator_vs_reference(reference):
    tmp, _ = reference
    a, c, s = (torch.from_numpy(v) for v in _locals().values())
    got = {"restrict": transfers.restrict(a), "prolong": transfers.prolong(a),
           "coarsen": transfers.coarsen_coefficient(c),
           "apply": mg.poisson_apply(None, a, c, SP, update_halo=False),
           "apply_shift": mg.poisson_apply(None, a, c, SP, update_halo=False, shift=s,
                                           use_kernel="ref")}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.load(tmp / f"{k}.npy"), rtol=1e-14,
                                   atol=1e-14, err_msg=k)
    # the block axes are a batch: each block transfers alone
    batch = torch.stack([a, 2 * a]).reshape(2, 1, 1, *LOCAL)
    for fn in (transfers.restrict, transfers.prolong, transfers.coarsen_coefficient):
        out = fn(batch)
        assert torch.equal(out[0, 0, 0], fn(a)) and torch.equal(out[1, 0, 0], fn(2 * a))


@pytest.mark.parametrize("name", list(CYCLES))
def test_build_coefficients_and_one_v_cycle(reference, name):
    tmp, _ = reference
    dims, n, per, smoother, shifted = CYCLES[name]
    g = init_global_grid(n, n, n, dims=dims, periodic=(per,) * 3, dtype=torch.float64,
                         device="cpu")
    grids = g.hierarchy()
    hs = mg.level_spacings(g, grids, SPACING)
    C, F = _global_fields()[per]
    c, f = g.scatter(C), g.scatter(F)
    c0 = c.clone()
    cs = mg.build_coefficients(g, grids, c)
    assert torch.equal(c, c0)   # the caller's field is not touched
    ss = mg.build_coefficients(g, grids, g.scatter(_shift_field(per))) if shifted else None
    v_cycle, residual = mg.make_v_cycle(g, grids, hs, cs, shifts=ss, smoother=smoother)
    u = v_cycle(0, torch.zeros_like(f), f)
    got = [u, residual(0, u, f)] + cs
    assert len(got) == 2 + len(grids)
    for k, (x, lv) in enumerate(zip(got, [g, g] + grids)):
        want = np.load(tmp / f"cycle_{name}_{k}.npy")
        scale = np.abs(want).max()
        np.testing.assert_allclose(lv.to_stacked(x), want, rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=f"output {k}")


def test_what_the_kernels_do_not_take_raises(monkeypatch):
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    u = g.ones()
    # the overlapped apply runs (hide_apply), but includes the halo update
    assert mg.poisson_apply(g, u, u, SPACING, hide=True, use_kernel="ref").shape == u.shape
    with pytest.raises(ValueError, match="already includes"):
        mg.poisson_apply(g, u, u, SPACING, hide=True, update_halo=False)
    # face locations are ported; a Helmholtz shift stays center only
    grids = g.hierarchy()
    hs, cs = mg.level_spacings(g, grids, SPACING), mg.build_coefficients(g, grids, u)
    assert callable(mg.make_v_cycle(g, grids, hs, cs, loc="xface")[0])
    with pytest.raises(ValueError, match="center cycle"):
        mg.make_v_cycle(g, grids, hs, cs, loc="xface", shifts=cs)
    with pytest.raises(ValueError, match="smoother"):
        mg.multigrid_solve(g, u, u, SPACING, smoother="sor")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mg.poisson_apply(g, u, u, SPACING, use_kernel="cuda")
    # where the kernels would run, a Helmholtz shift goes to the kernel (which
    # raises here, the tensor being on the CPU) instead of falling back to
    # the plain version; a 2-D grid raises; use_kernel="ref" runs both
    monkeypatch.setattr(dispatch, "resolve",
                        lambda use_kernel, x, where="": "ref" if use_kernel == "ref" else "cuda")
    n0 = sk.apply_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        mg.poisson_apply(g, u, u, SPACING, shift=u)
    with pytest.raises(ValueError, match="CUDA device"):
        mg.poisson_apply(g, u, u, SPACING, shift=u, hide=True)
    g2 = init_global_grid(10, 10, None, dims=(2, 2), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        mg.poisson_apply(g2, g2.ones(), g2.ones(), SPACING[:2], shift=g2.ones())
    assert sk.apply_cuda.launches == n0
    assert mg.poisson_apply(g, u, u, SPACING, shift=u, use_kernel="ref").shape == u.shape


@pytest.mark.cuda
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_v_cycle_kernels_vs_plain_on_card(smoother):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64)
    grids = g.hierarchy()
    hs = mg.level_spacings(g, grids, SPACING)
    C, F = _global_fields()[False]
    c, f = g.scatter(C), g.scatter(F)
    cs = mg.build_coefficients(g, grids, c)
    out = {}
    for mode in ("auto", "ref"):
        counts = [k.launches for k in (sk.residual_cuda, sk.jacobi_cuda, sk.cheb_cuda)]
        v_cycle, _ = mg.make_v_cycle(g, grids, hs, cs, smoother=smoother, use_kernel=mode)
        out[mode] = v_cycle(0, torch.zeros_like(f), f)
        launched = [k.launches - n for k, n in
                    zip((sk.residual_cuda, sk.jacobi_cuda, sk.cheb_cuda), counts)]
        assert (sum(launched) > 0) == (mode == "auto"), launched
    scale = out["ref"].abs().max().item()
    assert (out["auto"] - out["ref"]).abs().max().item() <= 1e-12 * scale
