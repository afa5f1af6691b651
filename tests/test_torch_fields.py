"""The port's staggered-field layer against the JAX package.

* ``Field``/``FieldSet`` masks (valid, owned, interior, solve) per location
  on 8 blocks, Dirichlet and periodic: equal to the reference's;
* ``fields.update_halo`` of a FieldSet, ``gather``/``scatter``: bitwise;
* ``fields.ops`` (``grad``, ``avg_to_face``, ``div(grad)``, ``avg_to_edge``,
  ``to_center``) across 8 blocks, with halo updates: to 1e-14, and the
  summation-by-parts adjointness of the differences and averages
  (``tests/test_property.py``);
* ``core.boundary.dirichlet``/``neumann0``, staggered or not, on 1 and 8
  blocks: bitwise;
* ``stencil.mac`` in torch and in NumPy (through the one ``xp`` adapter):
  bitwise in f64 against the reference's eager ``mac.*`` on local arrays;
  and in torch on the 8-block layout, where every roll must wrap inside its
  own block, to 1e-13 relative against the reference under ``shard_map``
  (its ``jit`` fuses the ops and may contract to FMA; a roll over the wrong
  axis would differ by O(1));
* the face transfers against ``repro.solvers.transfers`` per location (to
  1e-15) and their adjointness ``P = 2**3 R^T``.

The reference runs once in a module-scoped child process with 8 fake CPU
devices; arrays travel as ``.npz`` files made from a numpy seed.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import convert, fields  # noqa: E402
from repro_torch.core import boundary, init_global_grid  # noqa: E402
from repro_torch.core import locations as L  # noqa: E402
from repro_torch.fields import Field, FieldSet, ops  # noqa: E402
from repro_torch.solvers import reductions as red  # noqa: E402
from repro_torch.solvers import transfers  # noqa: E402
from repro_torch.stencil import mac  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

LOCS = ("center", "xface", "yface", "zface")
LOCAL = (10, 8, 6)
SP = (0.5, 0.25, 2.0)
MAC_SP = (0.3, 0.4, 0.5)
MAC_LOCAL = (9, 7, 8)
FINE, COARSE = (10, 8, 12), (6, 6, 8)

REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.core import boundary, init_global_grid
from repro.core.topology import make_grid_mesh
from repro import fields
from repro.fields import Field, FieldSet, ops
from repro.stencil import mac
from repro.solvers import transfers

TMP = {tmp!r}
LOCS, LOCAL, SP, MAC_SP = {locs!r}, {local!r}, {sp!r}, {mac_sp!r}
inp = dict(np.load(TMP + "/in.npz"))
out = {{}}


def local(g, fn, *args, n=1):
    spec = g.spec if n == 1 else tuple(g.spec for _ in range(n))
    sm = jax.shard_map(fn, mesh=g.mesh, in_specs=tuple(g.spec for _ in args), out_specs=spec,
                       check_vma=False)
    return jax.jit(sm)(*args)


for per in (False, True):
    g = init_global_grid(*LOCAL, dims=(2, 2, 2), periodic=(per, False, per), dtype=jnp.float64)
    for loc in LOCS:
        for kind in ("valid", "owned", "interior", "solve"):
            fn = getattr(fields, kind + "_mask")
            out[f"mask_{{per}}_{{loc}}_{{kind}}"] = local(g, lambda fn=fn, loc=loc: fn(g, loc))
    fs = FieldSet(a=Field(g, jnp.asarray(inp["A"]), "xface"),
                  b=Field(g, jnp.asarray(inp["B"]), "center"))
    h = g.parallel(lambda fs: fields.update_halo(g, fs))(fs)
    out[f"halo_{{per}}_a"], out[f"halo_{{per}}_b"] = h.a.data, h.b.data

g = init_global_grid(*LOCAL, dims=(2, 2, 2), dtype=jnp.float64)
for loc in LOCS:
    out[f"scatter_{{loc}}"] = fields.scatter(g, inp[f"G_{{loc}}"], loc).data
    out[f"gather_{{loc}}"] = fields.gather(Field(g, jnp.asarray(inp["A"]), loc))

c = fields.scatter(g, inp["Gc"], "center")


@g.parallel
def face_ops(c):
    c = fields.update_halo(g, c)
    G = fields.update_halo(g, ops.grad(c, SP))
    av = Field(g, ops.avg_to_face(c.data, 1), "yface")
    L = fields.update_halo(g, ops.div(G, SP))
    E = g.update_halo(ops.avg_to_edge(c.data, 0, 2))
    C = fields.update_halo(g, ops.to_center(G.x))
    return (G.x.data, G.y.data, G.z.data, fields.update_halo(g, av).data, L.data, E, C.data)


for k, o in enumerate(face_ops(c)):
    out[f"ops_{{k}}"] = o

mesh1 = make_grid_mesh(3, dims=(1, 1, 1), devices=jax.devices()[:1])
for nb, kw in ((1, dict(mesh=mesh1)), (8, dict(dims=(2, 2, 2)))):
    gb = init_global_grid(*LOCAL, dtype=jnp.float64, **kw)
    A = jnp.asarray(inp[f"A{{nb}}"])
    for dim in range(3):
        for stag in (False, True):
            out[f"dir_{{nb}}_{{dim}}_{{stag}}"] = local(
                gb, lambda a, dim=dim, stag=stag: boundary.dirichlet(gb.topo, a, 3.5, dim,
                                                                     staggered=stag), A)
            out[f"neu_{{nb}}_{{dim}}_{{stag}}"] = local(
                gb, lambda a, dim=dim, stag=stag: boundary.neumann0(gb.topo, a, dim,
                                                                    staggered=stag), A)


def mac_all(xp, U0, U1, U2, E):
    U = [U0, U1, U2]
    res = []
    for d in range(3):
        res += [mac.roll(xp, U0, d, +1), mac.roll(xp, U0, d, -1),
                mac.edge_avg(xp, E, d, (d + 1) % 3),
                mac.stripped_component(xp, U[d], E, MAC_SP, d),
                mac.stripped_diag_component(xp, E, MAC_SP, d)]
    res += mac.stripped_apply(xp, U, E, MAC_SP) + mac.stripped_diag(xp, E, MAC_SP)
    res += mac.full_stress_apply(xp, U, E, MAC_SP) + mac.full_stress_diag(xp, E, MAC_SP)
    return tuple(res)


mac_args = [jnp.asarray(inp[f"M{{k}}"]) for k in range(4)]
for k, o in enumerate(mac_all(jnp, *mac_args)):
    out[f"mac_local_{{k}}"] = o
g8 = init_global_grid(*{mac_local!r}, dims=(2, 2, 2), dtype=jnp.float64)
mac8 = [jnp.asarray(inp[f"M8_{{k}}"]) for k in range(4)]
for k, o in enumerate(local(g8, lambda *a: mac_all(jnp, *a), *mac8, n=len(mac_all(jnp, *mac_args)))):
    out[f"mac8_{{k}}"] = o

for loc in LOCS:
    out[f"restrict_{{loc}}"] = transfers.restrict(jnp.asarray(inp["fine"]), loc)
    out[f"prolong_{{loc}}"] = transfers.prolong(jnp.asarray(inp["coarse"]), loc)
np.savez(TMP + "/out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


def _stacked_shape(local, dims=(2, 2, 2)):
    return tuple(d * n for d, n in zip(dims, local))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fields")
    rng = np.random.RandomState(0)
    g = init_global_grid(*LOCAL, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    inp = {"A": rng.randn(*g.stacked_shape), "B": rng.randn(*g.stacked_shape),
           "Gc": rng.rand(*g.global_shape), "A1": rng.randn(*LOCAL), "A8": rng.randn(*g.stacked_shape),
           "fine": rng.randn(*FINE), "coarse": rng.randn(*COARSE)}
    for loc in LOCS:
        inp[f"G_{loc}"] = rng.randn(*fields.valid_global_shape(g, loc))
    for k in range(4):
        inp[f"M{k}"] = rng.rand(*MAC_LOCAL) + (0.5 if k == 3 else 0.0)
        inp[f"M8_{k}"] = rng.rand(*_stacked_shape(MAC_LOCAL)) + (0.5 if k == 3 else 0.0)
    for a in ("fine", "coarse"):   # zero ring: the transfers' contract
        arr = inp[a]
        for d in range(3):
            idx = [slice(None)] * 3
            idx[d] = [0, arr.shape[d] - 1]
            arr[tuple(idx)] = 0.0
    np.savez(tmp / "in.npz", **inp)
    run(REFERENCE.format(tmp=str(tmp), locs=LOCS, local=LOCAL, sp=SP, mac_sp=MAC_SP,
                         mac_local=MAC_LOCAL), ndev=8, timeout=600)
    return dict(np.load(tmp / "in.npz")), dict(np.load(tmp / "out.npz"))


def _grid(per=False, dims=(2, 2, 2), local=LOCAL):
    return init_global_grid(*local, dims=dims, periodic=(per, False, per), dtype=torch.float64,
                            device="cpu")


@pytest.mark.parametrize("per", [False, True])
@pytest.mark.parametrize("loc", LOCS)
def test_masks_equal_reference(reference, per, loc):
    _, out = reference
    g = _grid(per)
    for kind in ("valid", "owned", "interior", "solve"):
        got = g.to_stacked(getattr(fields, kind + "_mask")(g, loc))
        np.testing.assert_array_equal(got, out[f"mask_{per}_{loc}_{kind}"], err_msg=kind)
    f = fields.zeros(g, loc)
    np.testing.assert_array_equal(g.to_stacked(f.solve_mask()), out[f"mask_{per}_{loc}_solve"])
    np.testing.assert_array_equal(g.to_stacked(red.loc_solve_mask(g, loc)),
                                  out[f"mask_{per}_{loc}_solve"])


@pytest.mark.parametrize("per", [False, True])
def test_fieldset_update_halo_equals_reference(reference, per):
    inp, out = reference
    g = _grid(per)
    fs = FieldSet(a=Field(g, g.from_stacked(inp["A"]), "xface"),
                  b=Field(g, g.from_stacked(inp["B"]), "center"))
    h = fields.update_halo(g, fs)
    assert h.a.loc == "xface" and list(h.keys()) == ["a", "b"]
    np.testing.assert_array_equal(g.to_stacked(h.a.data), out[f"halo_{per}_a"])
    np.testing.assert_array_equal(g.to_stacked(h.b.data), out[f"halo_{per}_b"])


@pytest.mark.parametrize("loc", LOCS)
def test_gather_scatter_equal_reference(reference, loc):
    inp, out = reference
    g = _grid()
    f = fields.scatter(g, inp[f"G_{loc}"], loc)
    assert f.loc == loc and f.valid_global_shape == inp[f"G_{loc}"].shape
    np.testing.assert_array_equal(g.to_stacked(f.data), out[f"scatter_{loc}"])
    np.testing.assert_array_equal(fields.gather(f), inp[f"G_{loc}"])
    np.testing.assert_array_equal(fields.gather(Field(g, g.from_stacked(inp["A"]), loc)),
                                  out[f"gather_{loc}"])
    with pytest.raises(ValueError, match="valid shape"):
        fields.scatter(g, np.zeros(g.global_shape) if loc != "center" else np.zeros(3), loc)


def test_staggered_ops_equal_reference(reference):
    inp, out = reference
    g = _grid()
    c = fields.update_halo(g, fields.scatter(g, inp["Gc"], "center"))
    G = fields.update_halo(g, ops.grad(c, SP))
    av = fields.update_halo(g, Field(g, ops.avg_to_face(c.data, 1), "yface"))
    Lp = fields.update_halo(g, ops.div(G, SP))
    E = g.update_halo(ops.avg_to_edge(c.data, 0, 2))
    C = fields.update_halo(g, ops.to_center(G.x))
    assert (G.x.loc, G.y.loc, G.z.loc, Lp.loc, C.loc) == ("xface", "yface", "zface", "center",
                                                           "center")
    for k, got in enumerate((G.x.data, G.y.data, G.z.data, av.data, Lp.data, E, C.data)):
        np.testing.assert_allclose(g.to_stacked(got), out[f"ops_{k}"], rtol=1e-14, atol=1e-14,
                                   err_msg=str(k))
    # the NumPy forms of the reference's tests/test_fields.py
    Gc = inp["Gc"]
    np.testing.assert_allclose(fields.gather(G.x), np.diff(Gc, axis=0) / SP[0], rtol=1e-13)
    np.testing.assert_allclose(fields.gather(av), 0.5 * (Gc[:, :-1, :] + Gc[:, 1:, :]), rtol=1e-13)
    with pytest.raises(ValueError, match="center"):
        ops.grad(G.x, SP)
    with pytest.raises(ValueError, match="two components"):
        ops.div(FieldSet(a=G.x, b=G.x), SP)


@pytest.mark.parametrize("seed", range(6))
def test_fields_ops_adjointness(seed):
    """Summation by parts: <diff_to_face(c), f> == -<c, diff_to_center(f)> and
    <avg_to_face(c), f> == <c, avg_to_center(f)> when f vanishes on its
    plane 0 and dead plane along d (``tests/test_property.py``)."""
    rng = np.random.RandomState(seed)
    shape = tuple(rng.randint(3, 10, size=3))
    d = seed % 3
    c = torch.from_numpy(rng.randn(*shape))
    f = torch.from_numpy(rng.randn(*shape))
    f.select(d, 0).zero_()
    f.select(d, shape[d] - 1).zero_()
    h = float(0.5 + rng.rand())
    lhs = float((ops.diff_to_face(c, d, h) * f).sum())
    rhs = float((c * ops.diff_to_center(f, d, h)).sum())
    assert abs(lhs + rhs) <= 1e-12 * (float(c.norm() * f.norm()) / h + 1.0), (lhs, rhs)
    lhs = float((ops.avg_to_face(c, d) * f).sum())
    rhs = float((c * ops.avg_to_center(f, d)).sum())
    assert abs(lhs - rhs) <= 1e-12 * (float(c.norm() * f.norm()) + 1.0), (lhs, rhs)


@pytest.mark.parametrize("nb", [1, 8])
def test_boundary_equals_reference(reference, nb):
    inp, out = reference
    g = _grid(dims=(1, 1, 1) if nb == 1 else (2, 2, 2))
    A = g.from_stacked(inp[f"A{nb}"])
    before = A.clone()
    for dim in range(3):
        for stag in (False, True):
            got = boundary.dirichlet(g.topo, A, 3.5, dim, staggered=stag)
            np.testing.assert_array_equal(g.to_stacked(got), out[f"dir_{nb}_{dim}_{stag}"])
            got = boundary.neumann0(g.topo, A, dim, staggered=stag)
            np.testing.assert_array_equal(g.to_stacked(got), out[f"neu_{nb}_{dim}_{stag}"])
    assert torch.equal(A, before)   # the input is left as it was


def _mac_all(xp, U0, U1, U2, E):
    U = [U0, U1, U2]
    res = []
    for d in range(3):
        res += [mac.roll(xp, U0, d, +1), mac.roll(xp, U0, d, -1),
                mac.edge_avg(xp, E, d, (d + 1) % 3),
                mac.stripped_component(xp, U[d], E, MAC_SP, d),
                mac.stripped_diag_component(xp, E, MAC_SP, d)]
    res += mac.stripped_apply(xp, U, E, MAC_SP) + mac.stripped_diag(xp, E, MAC_SP)
    res += mac.full_stress_apply(xp, U, E, MAC_SP) + mac.full_stress_diag(xp, E, MAC_SP)
    return res


def test_mac_bitwise_on_local_arrays_torch_and_numpy(reference):
    inp, out = reference
    args = [inp[f"M{k}"] for k in range(4)]
    got_t = _mac_all(torch, *(torch.from_numpy(a) for a in args))
    got_n = _mac_all(np, *args)
    assert len(got_t) == len([k for k in out if k.startswith("mac_local_")])
    for k, (t, n) in enumerate(zip(got_t, got_n)):
        np.testing.assert_array_equal(t.numpy(), out[f"mac_local_{k}"], err_msg=f"torch {k}")
        np.testing.assert_array_equal(n, out[f"mac_local_{k}"], err_msg=f"numpy {k}")


def test_mac_bitwise_on_eight_blocks(reference):
    """On the (*dims, *local) layout every roll wraps inside its own block;
    a roll over a block axis would give right interiors on one block and
    wrong ones here."""
    inp, out = reference
    g = _grid(local=MAC_LOCAL)
    got = _mac_all(torch, *(g.from_stacked(inp[f"M8_{k}"]) for k in range(4)))
    for k, t in enumerate(got):
        want = out[f"mac8_{k}"]
        np.testing.assert_allclose(g.to_stacked(t), want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max(), err_msg=str(k))


@pytest.mark.parametrize("loc", LOCS)
def test_transfers_per_location_equal_reference(reference, loc):
    inp, out = reference
    np.testing.assert_allclose(transfers.restrict(torch.from_numpy(inp["fine"]), loc).numpy(),
                               out[f"restrict_{loc}"], rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(transfers.prolong(torch.from_numpy(inp["coarse"]), loc).numpy(),
                               out[f"prolong_{loc}"], rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("loc", LOCS)
def test_transfer_adjointness_per_location(loc):
    """<R u, v>_coarse == <u, P v>_fine / 2**3 for u, v zero on their rings,
    and the batched block layout transfers each block on its own."""
    for seed in range(5):
        rng = np.random.RandomState(seed)
        shape = tuple(int(rng.choice([6, 8, 10])) for _ in range(3))
        cshape = tuple((n - 2) // 2 + 2 for n in shape)
        u, v = rng.randn(*shape), rng.randn(*cshape)
        for a in (u, v):
            for d in range(3):
                idx = [slice(None)] * 3
                idx[d] = [0, a.shape[d] - 1]
                a[tuple(idx)] = 0.0
        u, v = torch.from_numpy(u), torch.from_numpy(v)
        lhs = float((transfers.restrict(u, loc) * v).sum())
        rhs = float((u * transfers.prolong(v, loc)).sum()) / 8.0
        assert abs(lhs - rhs) <= 1e-12 * (float(u.norm() * v.norm()) + 1.0), (loc, lhs, rhs)
    batch = torch.from_numpy(np.random.RandomState(9).randn(2, 2, 2, 10, 8, 6))
    whole = transfers.restrict(batch, loc)
    assert torch.equal(whole[1, 0, 1], transfers.restrict(batch[1, 0, 1], loc))


def test_field_and_fieldset_contract():
    g = _grid()
    a = fields.from_global_fn(g, lambda ix, iy, iz: (ix + 2 * iy + 3 * iz).double(), "yface")
    G = fields.gather(a)
    assert G.shape == (g.global_shape[0], g.global_shape[1] - 1, g.global_shape[2])
    assert float(g.to_stacked(a.data)[:, -1, :].max()) == 0.0          # dead plane zero
    b = fields.from_global_fn(g, lambda ix, iy, iz: torch.ones_like(ix).double(), "yface")
    assert ((a + b) - b).loc == "yface" and torch.equal(((a + b) - b).data, a.data)
    assert torch.equal((2.0 * a).data, (a * 2.0).data) and torch.equal((-a).data, -a.data)
    with pytest.raises(ValueError, match="location mismatch"):
        _ = a + fields.zeros(g, "xface")
    with pytest.raises(ValueError, match="unknown location"):
        fields.zeros(g, "edge")
    fs = FieldSet(vx=fields.zeros(g, "xface"), vy=a)
    assert fs.vy is a and fs["vx"].loc == "xface" and len(fs) == 2
    assert [f.loc for f in fs] == ["xface", "yface"]
    doubled = fs.map(lambda f: f * 2.0)
    assert torch.equal(doubled.vy.data, 2.0 * a.data)
    # the solvers' duck-typed tree helpers
    assert L.is_field_node(a) and L.is_field_set(fs) and not L.is_field_set(a)
    assert L.loc_of(a) == "yface" and L.loc_of(a.data) == "center" and L.data_of(a) is a.data
    leaves = L.tree_leaves(fs)
    assert len(leaves) == 2 and leaves[1] is a.data
    summed = L.tree_map(torch.add, fs, doubled)
    assert L.is_field_set(summed) and summed.vy.loc == "yface"
    assert torch.equal(summed.vy.data, 3.0 * a.data)
    masks = fields.solve_mask_tree(g, fs)
    assert torch.equal(masks.vy.data, fields.solve_mask(g, "yface"))
    assert float(red.tree_dot(g, fs, fs, masks)) == float(red.dot(g, a.data, a.data,
                                                                   masks.vy.data))


def test_convert_fields_both_ways():
    g = _grid()
    rng = np.random.RandomState(3)
    A, B = rng.randn(*g.stacked_shape), rng.randn(*g.stacked_shape)
    f = convert.field_from_reference(g, A, "zface")
    assert f.loc == "zface"
    back, loc = convert.field_to_reference(f)
    np.testing.assert_array_equal(back, A)
    fs = convert.fieldset_from_reference(g, vx=(A, "xface"), P=(B, "center"))
    assert list(fs.keys()) == ["vx", "P"] and fs.P.loc == "center"
    out = convert.fieldset_to_reference(fs)
    np.testing.assert_array_equal(out["P"][0], B)
    assert out["vx"][1] == "xface"
