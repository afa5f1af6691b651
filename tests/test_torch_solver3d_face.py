"""The face variants of the port's fused solver operators (plain versions of
K2-K5 face and their dispatch) against the JAX package's
``kernels/solver3d``.

For ``sd = 0, 1, 2`` (x/y/z faces) the plain versions of apply, residual,
Jacobi and Chebyshev (first and later step), and the masked face
diagonal, are held against the reference's ``ref.py`` (f64: bitwise; f32:
1e-6), its ``*_pallas(..., sd=sd, interpret=True)`` and its ``blocked_ref``
(rtol = atol = 1e-6 in f32 and 1e-12 in f64: the reference's own envelope
for its compiled paths, ``tests/test_kernel_solver3d.py:161-208``) at the
shapes and block sizes of that file, with the location's interior mask of
a one-block grid (pinned faces and dead plane zero).  The reference runs
once in a module-scoped child process; arrays travel as ``.npy`` files made
from a numpy seed.

The roll-form face stencil wraps inside each local block: the tests hold
the block-batched layout ``(2, 2, 2, *local)`` to the per-block results and
to the reference on every block.  The CUDA kernels run only on a card;
those tests carry the ``cuda`` marker and hold each face kernel against its
plain version, normwise (f32 1e-6, f64 1e-12) with the masked cells
bitwise.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.core import locations as L  # noqa: E402
from repro_torch.kernels.solver3d import (  # noqa: E402
    apply_face_cuda, apply_op, apply_op_ref, cheb_face_cuda, cheb_sweep, cheb_sweep_ref,
    face_diag, face_stencil, full_diag, jacobi_face_cuda, jacobi_sweep, jacobi_sweep_ref,
    residual_face_cuda, residual_op, residual_op_ref,
)

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

SP = (0.5, 0.7, 1.1)
H2 = tuple(float(s) ** 2 for s in SP)
OMEGA = 6.0 / 7.0
CHEB = ((None, 1.25), (0.3, 0.9))     # (a, b): the first step, then a later one
CASES = [((8, 8, 8), 8), ((8, 8, 8), 4), ((12, 6, 8), 4), ((8, 8, 8), 2), ((6, 6, 6), 6),
         ((16, 10, 12), 8)]
LOCS = ("xface", "yface", "zface")
DTYPES = {"float32": (torch.float32, 1e-6), "float64": (torch.float64, 1e-12)}
OUTS = ("apply", "residual", "jacobi", "cheb0_u", "cheb0_d", "cheb1_u", "cheb1_d", "dia")


def face_mask(shape, sd):
    """The interior mask of a face location on one Dirichlet block: the
    ring across dims; along ``sd`` the pinned faces 0 and n-2 and the dead
    plane n-1."""
    m = np.zeros(shape)
    sl = [slice(1, -1)] * 3
    sl[sd] = slice(1, shape[sd] - 2)
    m[tuple(sl)] = 1.0
    return m


REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.kernels.solver3d import kernel as K, ref as R

TMP = {tmp!r}
SP, H2, OMEGA, CHEB = {sp!r}, {h2!r}, {omega!r}, {cheb!r}
for i, (shape, bx) in enumerate({cases!r}):
    for loc in {locs!r}:
        sd = ("xface", "yface", "zface").index(loc)
        for dt in ("float32", "float64"):
            u, c, f, d0 = (jnp.asarray(np.load(f"{{TMP}}/{{n}}{{i}}.npy"), dt) for n in "ucfd")
            m = jnp.asarray(np.load(f"{{TMP}}/m{{i}}_{{sd}}.npy"), dt)
            dia = R.full_diag(c, SP, loc, m)
            ref = [R.apply_op_ref(u, c, SP, loc), R.residual_op_ref(u, c, f, SP, loc, m),
                   R.jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=SP, loc=loc, imask=m)]
            pal = [K.apply_pallas(u, c, h2=H2, sd=sd, bx=bx, interpret=True),
                   K.residual_pallas(u, c, f, h2=H2, sd=sd, imask=m, bx=bx, interpret=True),
                   K.jacobi_pallas(u, c, f, dia, omega=OMEGA, h2=H2, sd=sd, imask=m, bx=bx,
                                   interpret=True)]
            blk = [K.blocked_ref("apply", u, c, h2=H2, sd=sd, bx=bx),
                   K.blocked_ref("residual", u, c, f, h2=H2, sd=sd, imask=m, bx=bx),
                   K.blocked_ref("jacobi", u, c, f, dia, h2=H2, sd=sd, imask=m, bx=bx,
                                 omega=OMEGA)]
            for a, b in CHEB:
                ref += list(R.cheb_sweep_ref(u, c, f, dia, d0, a=a, b=b, spacing=SP, loc=loc,
                                             imask=m))
                pal += list(K.cheb_pallas(u, c, f, dia, d0, a=a, b=b, h2=H2, sd=sd, imask=m,
                                          bx=bx, interpret=True))
                blk += list(K.blocked_ref("cheb", u, c, f, dia, d0, h2=H2, sd=sd, imask=m,
                                          bx=bx, a=a, b=b))
            for kind, outs in (("ref", ref + [dia]), ("pallas", pal + [dia]),
                               ("blocked", blk + [dia])):
                np.save(f"{{TMP}}/{{kind}}_{{i}}_{{sd}}_{{dt}}.npy",
                        np.stack([np.asarray(o, np.float64) for o in outs]))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_solver3d_face")
    rng = np.random.RandomState(0)
    for i, (shape, _) in enumerate(CASES):
        for n in "ucfd":
            np.save(tmp / f"{n}{i}.npy", rng.rand(*shape) + (0.5 if n == "c" else 0.0))
        for sd in range(3):
            np.save(tmp / f"m{i}_{sd}.npy", face_mask(shape, sd))
    run(REFERENCE.format(tmp=str(tmp), sp=SP, h2=H2, omega=OMEGA, cheb=CHEB, cases=CASES,
                         locs=LOCS), ndev=1)
    return tmp


def _load(tmp, name, dtype):
    return torch.from_numpy(np.load(tmp / f"{name}.npy")).to(dtype)


def _plain(u, c, f, d0, m, loc, **kw):
    """Every output of the plain versions, in the order of ``OUTS``."""
    dia = full_diag(c, SP, loc, m)
    outs = [apply_op(u, c, spacing=SP, loc=loc, **kw),
            residual_op(u, c, f, spacing=SP, loc=loc, imask=m, **kw),
            jacobi_sweep(u, c, f, dia, omega=OMEGA, spacing=SP, loc=loc, imask=m, **kw)]
    for a, b in CHEB:
        outs += list(cheb_sweep(u, c, f, dia, d0, a=a, b=b, spacing=SP, loc=loc, imask=m, **kw))
    return outs + [dia]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("i", range(len(CASES)))
def test_face_plain_versions_vs_jax_ref_pallas_and_blocked(reference, i, loc, dt):
    dtype, tol = DTYPES[dt]
    sd = L.stagger_dim(loc)
    u, c, f, d0 = (_load(reference, f"{n}{i}", dtype) for n in "ucfd")
    m = _load(reference, f"m{i}_{sd}", dtype)
    got = _plain(u, c, f, d0, m, loc)   # auto on a CPU tensor: the plain versions
    for name, g in zip(OUTS, got):
        assert g.dtype == dtype and g.shape == u.shape, name
    got = np.stack([g.double().numpy() for g in got])
    for kind in ("ref", "pallas", "blocked"):
        want = np.load(reference / f"{kind}_{i}_{sd}_{dt}.npy")
        for k, name in enumerate(OUTS):
            if kind == "ref" and dt == "float64":
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kind} {name}")
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                           err_msg=f"{kind} {name}")


def test_batched_blocks_wrap_inside_each_block():
    """On the (2, 2, 2, *local) layout every block is computed on its own:
    the rolls wrap inside the block, never into the neighbouring one."""
    rng = np.random.RandomState(4)
    shape = (2, 2, 2, 9, 7, 8)
    u, c, f, d0 = (torch.from_numpy(rng.rand(*shape) + 0.5) for _ in range(4))
    for loc in LOCS:
        m = torch.from_numpy(np.broadcast_to(face_mask(shape[3:], L.stagger_dim(loc)),
                                             shape).copy())
        whole = _plain(u, c, f, d0, m, loc)
        for b in np.ndindex(2, 2, 2):
            for got, want in zip(whole, _plain(u[b], c[b], f[b], d0[b], m[b], loc)):
                assert torch.equal(got[b], want), (loc, b)


def test_masked_cells_and_mask_contract():
    rng = np.random.RandomState(5)
    shape = (7, 9, 8)
    u, c, f, d0 = (torch.from_numpy(rng.rand(*shape) + 0.5) for _ in range(4))
    for loc in LOCS:
        sd = L.stagger_dim(loc)
        m = torch.from_numpy(face_mask(shape, sd))
        dead = m == 0
        dia = full_diag(c, SP, loc, m)
        assert torch.equal(dia[dead], torch.ones_like(dia[dead]))
        assert torch.equal(dia[~dead], face_diag(c, SP, sd)[~dead])
        assert torch.equal(apply_op_ref(u, c, SP, loc), face_stencil(u, c, SP, sd))
        assert torch.equal(residual_op_ref(u, c, f, SP, loc, imask=m)[dead],
                           torch.zeros_like(u[dead]))
        assert torch.equal(jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=SP, loc=loc,
                                            imask=m)[dead], u[dead])
        cu, cd = cheb_sweep_ref(u, c, f, dia, d0, a=None, b=1.25, spacing=SP, loc=loc, imask=m)
        assert torch.equal(cu[dead], u[dead]) and torch.equal(cd[dead], torch.zeros_like(u[dead]))
        cu, cd = cheb_sweep_ref(u, c, f, dia, d0, a=0.3, b=0.9, spacing=SP, loc=loc, imask=m)
        assert torch.equal(cd[dead], 0.3 * d0[dead]) and torch.equal(cu[dead], u[dead] + cd[dead])
        # the first step does not read d
        a1 = cheb_sweep_ref(u, c, f, dia, torch.full_like(d0, float("nan")), a=None, b=1.25,
                            spacing=SP, loc=loc, imask=m)
        assert all(torch.isfinite(t).all() for t in a1)
        # a face location without its mask raises, as the reference's ops do
        with pytest.raises(ValueError, match="interior mask"):
            residual_op(u, c, f, spacing=SP, loc=loc)
        with pytest.raises(ValueError, match="interior mask"):
            jacobi_sweep(u, c, f, dia, omega=OMEGA, spacing=SP, loc=loc)
        with pytest.raises(ValueError, match="interior mask"):
            cheb_sweep(u, c, f, dia, d0, a=None, b=1.0, spacing=SP, loc=loc, use_kernel="ref")
        with pytest.raises(ValueError, match="interior mask"):
            full_diag(c, SP, loc)
        with pytest.raises(ValueError, match="center only"):
            residual_op(u, c, f, spacing=SP, loc=loc, imask=m, shift=u, use_kernel="ref")
        # the launchers refuse CPU tensors outright
        for call in (lambda: apply_face_cuda(u, c, sd=sd, h2=H2),
                     lambda: residual_face_cuda(u, c, f, m, sd=sd, h2=H2),
                     lambda: jacobi_face_cuda(u, c, f, dia, m, sd=sd, omega=OMEGA, h2=H2),
                     lambda: cheb_face_cuda(u, c, f, dia, m, None, sd=sd, a=None, b=1.0, h2=H2)):
            with pytest.raises(ValueError, match="CUDA"):
                call()
        with pytest.raises(ValueError, match="CUDA"):
            apply_op(u, c, spacing=SP, loc=loc, use_kernel="cuda")


def test_real_grid_masks_on_eight_blocks():
    """With the interior mask of an 8-block Dirichlet grid, the masked cells
    of every block (global pinned faces and dead plane, plus the ring of
    the outer blocks) stay put, as the V-cycle needs."""
    g = init_global_grid(10, 6, 8, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(6)
    u, c, f = (torch.from_numpy(rng.rand(*g.shape) + 0.5) for _ in range(3))
    for loc in LOCS:
        m = L.interior_mask(g, loc)
        dia = full_diag(c, SP, loc, m)
        out = jacobi_sweep(u, c, f, dia, omega=OMEGA, spacing=SP, loc=loc, imask=m)
        assert torch.equal(out[m == 0], u[m == 0])
        assert not torch.equal(out[m == 1], u[m == 1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_face_kernels_vs_plain_on_card(cuda_device, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.RandomState(8)
    wrappers = (apply_face_cuda, residual_face_cuda, jacobi_face_cuda, cheb_face_cuda)
    for shape in [(1, 9, 7, 11), (8, 34, 18, 66), (2, 2, 2, 18, 10, 34)]:
        u, c, f, d0 = (torch.from_numpy(rng.rand(*shape) + 0.5).to(cuda_device, dtype)
                       for _ in range(4))
        for loc in LOCS:
            sd = L.stagger_dim(loc)
            m = torch.from_numpy(np.broadcast_to(face_mask(shape[-3:], sd), shape).copy()
                                 ).to(cuda_device, dtype)
            dia = full_diag(c, SP, loc, m)
            for sl in (np.s_[...], np.s_[..., 1:8, :, 3:9]):   # whole blocks, strided views
                a = [t[sl] for t in (u, c, f, d0, dia, m)]
                n0 = [w.launches for w in wrappers]
                pairs = {"apply": (apply_op(a[0], a[1], spacing=SP, loc=loc),
                                   apply_op_ref(a[0], a[1], SP, loc)),
                         "residual": (residual_op(a[0], a[1], a[2], spacing=SP, loc=loc,
                                                  imask=a[5]),
                                      residual_op_ref(a[0], a[1], a[2], SP, loc, imask=a[5])),
                         "jacobi": (jacobi_sweep(a[0], a[1], a[2], a[4], omega=OMEGA, spacing=SP,
                                                 loc=loc, imask=a[5]),
                                    jacobi_sweep_ref(a[0], a[1], a[2], a[4], omega=OMEGA,
                                                     spacing=SP, loc=loc, imask=a[5]))}
                for ca, cb in CHEB:
                    k = cheb_sweep(a[0], a[1], a[2], a[4], a[3], a=ca, b=cb, spacing=SP, loc=loc,
                                   imask=a[5])
                    p = cheb_sweep_ref(a[0], a[1], a[2], a[4], a[3], a=ca, b=cb, spacing=SP,
                                       loc=loc, imask=a[5])
                    pairs[f"cheb(a={ca}) u"], pairs[f"cheb(a={ca}) d"] = (k[0], p[0]), (k[1], p[1])
                torch.cuda.synchronize()
                assert [w.launches for w in wrappers] == [n0[0] + 1, n0[1] + 1, n0[2] + 1,
                                                          n0[3] + 2]
                dead = (a[5] == 0).expand(a[0].shape)
                for name, (got, want) in pairs.items():
                    assert got.shape == a[0].shape and got.dtype == dtype and got.is_contiguous()
                    g, w = got.double(), want.double()
                    err = (g - w).abs().max().item()
                    assert err <= tol * max(w.abs().max().item(), 1.0), (loc, name, err)
                    if name != "apply":
                        assert torch.equal(got[dead], want[dead]), f"{loc} {name}: masked cells"


@pytest.mark.cuda
def test_face_kernels_reject_what_they_do_not_take(cuda_device):
    u = torch.rand(8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        apply_face_cuda(u, u, sd=3, h2=H2)
    with pytest.raises(ValueError):
        residual_face_cuda(u, u, u, None, sd=0, h2=H2)
    with pytest.raises(ValueError):
        jacobi_face_cuda(u, u, u, u, u.double(), sd=1, omega=OMEGA, h2=H2)
    with pytest.raises(ValueError):
        residual_op(u.half(), u.half(), u.half(), spacing=SP, loc="xface", imask=u.half())
