"""The fused solver operators of the port (plain versions of K2-K5 and their
dispatch) against the JAX package's ``kernels/solver3d``.

The plain versions of apply, residual, Jacobi and Chebyshev (first and
later step) are held against the reference's ``ref.py``, its
``*_pallas(..., interpret=True)`` and its ``blocked_ref`` at the shapes and
block sizes of ``tests/test_kernel_solver3d.py``, center location, in f32
and f64.  The reference runs once in a module-scoped child process; arrays
travel as ``.npy`` files made from a numpy seed.  Tolerances (rtol = atol):
f32 1e-6, f64 1e-12 — the frameworks round the same expression at
different places.

The CUDA kernels run only on a card; those tests carry the ``cuda`` marker
and hold each kernel against its plain version with the normwise tolerance
``max|kernel - plain| <= tol * max|plain|`` (f32 1e-6, f64 1e-12: the
kernels multiply by ``1/h^2`` and may contract to FMA), the ring bitwise.
"""

from __future__ import annotations

import ast
import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.solver3d import (  # noqa: E402
    apply_cuda, apply_op, apply_op_ref, cheb_cuda, cheb_sweep, cheb_sweep_ref, full_diag,
    jacobi_cuda, jacobi_sweep, jacobi_sweep_ref, ops, poisson_diag, residual_cuda, residual_op,
    residual_op_ref,
)

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

SP = (0.5, 0.7, 1.1)
H2 = tuple(float(s) ** 2 for s in SP)
OMEGA = 6.0 / 7.0
CHEB = ((None, 1.25), (0.3, 0.9))     # (a, b): the first step, then a later one
# (shape, bx) of tests/test_kernel_solver3d.py: nb = 1, 2, 3, 4, non-cubic
CASES = [((8, 8, 8), 8), ((8, 8, 8), 4), ((12, 6, 8), 4), ((8, 8, 8), 2), ((6, 6, 6), 6),
         ((16, 10, 12), 8)]
DTYPES = {"float32": (torch.float32, 1e-6), "float64": (torch.float64, 1e-12)}
OUTS = ("apply", "residual", "jacobi", "cheb0_u", "cheb0_d", "cheb1_u", "cheb1_d", "dia")

REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.kernels.solver3d import kernel as K, ref as R

TMP = {tmp!r}
SP, H2, OMEGA, CHEB = {sp!r}, {h2!r}, {omega!r}, {cheb!r}
for i, (shape, bx) in enumerate({cases!r}):
    for dt in ("float32", "float64"):
        u, c, f, d0 = (jnp.asarray(np.load(f"{{TMP}}/{{n}}{{i}}.npy"), dt) for n in "ucfd")
        dia = R.full_diag(c, SP, "center")
        ref = [R.apply_op_ref(u, c, SP), R.residual_op_ref(u, c, f, SP),
               R.jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=SP)]
        pal = [K.apply_pallas(u, c, h2=H2, bx=bx, interpret=True),
               K.residual_pallas(u, c, f, h2=H2, bx=bx, interpret=True),
               K.jacobi_pallas(u, c, f, dia, omega=OMEGA, h2=H2, bx=bx, interpret=True)]
        blk = [K.blocked_ref("apply", u, c, h2=H2, bx=bx),
               K.blocked_ref("residual", u, c, f, h2=H2, bx=bx),
               K.blocked_ref("jacobi", u, c, f, dia, h2=H2, bx=bx, omega=OMEGA)]
        for a, b in CHEB:
            ref += list(R.cheb_sweep_ref(u, c, f, dia, d0, a=a, b=b, spacing=SP))
            pal += list(K.cheb_pallas(u, c, f, dia, d0, a=a, b=b, h2=H2, bx=bx, interpret=True))
            blk += list(K.blocked_ref("cheb", u, c, f, dia, d0, h2=H2, bx=bx, a=a, b=b))
        for kind, outs in (("ref", ref + [dia]), ("pallas", pal + [dia]), ("blocked", blk + [dia])):
            np.save(f"{{TMP}}/{{kind}}_{{i}}_{{dt}}.npy",
                    np.stack([np.asarray(o, np.float64) for o in outs]))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_solver3d")
    rng = np.random.RandomState(0)
    for i, (shape, _) in enumerate(CASES):
        for n in "ucfd":
            np.save(tmp / f"{n}{i}.npy", rng.rand(*shape) + (0.5 if n == "c" else 0.0))
    run(REFERENCE.format(tmp=str(tmp), sp=SP, h2=H2, omega=OMEGA, cheb=CHEB, cases=CASES),
        ndev=1)
    return tmp


def _inputs(tmp, i, dtype):
    return tuple(torch.from_numpy(np.load(tmp / f"{n}{i}.npy")).to(dtype) for n in "ucfd")


def _plain(u, c, f, d0, **kw):
    """Every output of the plain versions, in the order of ``OUTS``."""
    dia = full_diag(c, SP)
    outs = [apply_op(u, c, spacing=SP, **kw), residual_op(u, c, f, spacing=SP, **kw),
            jacobi_sweep(u, c, f, dia, omega=OMEGA, spacing=SP, **kw)]
    for a, b in CHEB:
        outs += list(cheb_sweep(u, c, f, dia, d0, a=a, b=b, spacing=SP, **kw))
    return outs + [dia]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_versions_vs_jax_ref_pallas_and_blocked(reference, i, dt):
    dtype, tol = DTYPES[dt]
    u, c, f, d0 = _inputs(reference, i, dtype)
    got = _plain(u, c, f, d0)   # auto on a CPU tensor: the plain versions
    for name, g in zip(OUTS, got):
        assert g.dtype == dtype and g.shape == u.shape, name
    got = np.stack([g.double().numpy() for g in got])
    for kind in ("ref", "pallas", "blocked"):
        want = np.load(reference / f"{kind}_{i}_{dt}.npy")
        for k, name in enumerate(OUTS):
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=f"{kind} {name}")


def test_ring_values_and_interior_diagonal():
    rng = np.random.RandomState(1)
    u, c, f, d0 = (torch.from_numpy(rng.rand(7, 9, 8) + 0.5) for _ in range(4))
    dia = full_diag(c, SP)
    assert torch.equal(dia[1:-1, 1:-1, 1:-1], poisson_diag(c, SP))
    outs = {"apply": (apply_op_ref(u, c, SP), 0), "residual": (residual_op_ref(u, c, f, SP), 0),
            "jacobi": (jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=SP), u),
            "dia": (dia, 1)}
    cu, cd = cheb_sweep_ref(u, c, f, dia, d0, a=0.3, b=0.9, spacing=SP)
    outs.update(cheb_u=(cu, u), cheb_d=(cd, 0))
    ring = torch.ones(7, 9, 8, dtype=torch.bool)
    ring[1:-1, 1:-1, 1:-1] = False
    for name, (out, want) in outs.items():
        want = want[ring] if torch.is_tensor(want) else torch.full_like(out[ring], want)
        assert torch.equal(out[ring], want), name


def test_batched_equals_per_block():
    rng = np.random.RandomState(4)
    u, c, f, d0 = (torch.from_numpy(rng.rand(2, 3, 9, 7, 8) + 0.5) for _ in range(4))
    whole = _plain(u, c, f, d0)
    for a in range(2):
        for b in range(3):
            for got, want in zip(whole, _plain(u[a, b], c[a, b], f[a, b], d0[a, b])):
                assert torch.equal(got[a, b], want)


def test_first_chebyshev_step_does_not_read_d():
    rng = np.random.RandomState(5)
    u, c, f, d0 = (torch.from_numpy(rng.rand(6, 7, 8) + 0.5) for _ in range(4))
    dia = full_diag(c, SP)
    a1 = cheb_sweep_ref(u, c, f, dia, d0, a=None, b=1.25, spacing=SP)
    a2 = cheb_sweep_ref(u, c, f, dia, torch.full_like(d0, float("nan")), a=None, b=1.25,
                        spacing=SP)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


def test_dispatch_rules():
    u = torch.rand(6, 6, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        apply_op(u, u, spacing=SP, use_kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        jacobi_sweep(u, u, u, u, omega=OMEGA, spacing=SP, use_kernel="cuda")
    with pytest.raises(ValueError, match="unknown use_kernel"):
        residual_op(u, u, u, spacing=SP, use_kernel="pallas")
    for loc in ("xface", "yface", "zface"):
        # the face variants take the location's interior mask (ported with
        # the staggered slice; tests/test_torch_solver3d_face.py holds them)
        assert apply_op(u, u, spacing=SP, loc=loc).shape == u.shape
        with pytest.raises(ValueError, match="interior mask"):
            cheb_sweep(u, u, u, u, u, a=None, b=1.0, spacing=SP, loc=loc, use_kernel="ref")
        with pytest.raises(ValueError, match="interior mask"):
            full_diag(u, SP, loc)
    with pytest.raises(ValueError, match="unknown location"):
        residual_op(u, u, u, spacing=SP, loc="edge")
    # the launchers refuse CPU tensors outright
    for call in (lambda: apply_cuda(u, u, h2=H2), lambda: residual_cuda(u, u, u, h2=H2),
                 lambda: jacobi_cuda(u, u, u, u, omega=OMEGA, h2=H2),
                 lambda: cheb_cuda(u, u, u, u, None, a=None, b=1.0, h2=H2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_ops_hold_no_fallback():
    tree = ast.parse(inspect.getsource(ops))
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
    assert dispatch.resolve("auto", torch.zeros(3, 3, 3)) == "ref"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _normwise(got, want, tol, name):
    g, w = got.double(), want.double()
    err = (g - w).abs().max().item()
    assert err <= tol * max(w.abs().max().item(), 1.0), f"{name}: max |err| {err}"


def _ring_mask(shape, device):
    m = torch.ones(shape[-3:], dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = False
    return m.expand(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernels_vs_plain_on_card(cuda_device, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.RandomState(8)
    for shape in [(1, 10, 10, 10), (8, 34, 18, 66), (2, 2, 2, 18, 10, 34)]:
        u, c, f, d0 = (torch.from_numpy(rng.rand(*shape) + 0.5).to(cuda_device, dtype)
                       for _ in range(4))
        dia = full_diag(c, SP)
        for sl in (np.s_[...], np.s_[..., 1:8, :, 3:9]):   # whole blocks, strided views
            a_u, a_c, a_f, a_dia, a_d = u[sl], c[sl], f[sl], dia[sl], d0[sl]
            ring = _ring_mask(a_u.shape, cuda_device)
            n0 = [k.launches for k in (apply_cuda, residual_cuda, jacobi_cuda, cheb_cuda)]
            pairs = {
                "apply": (apply_cuda(a_u, a_c, h2=H2),
                          apply_op_ref(a_u, a_c, SP), 0),
                "residual": (residual_cuda(a_u, a_c, a_f, h2=H2),
                             residual_op_ref(a_u, a_c, a_f, SP), 0),
                "jacobi": (jacobi_cuda(a_u, a_c, a_f, a_dia, omega=OMEGA, h2=H2),
                           jacobi_sweep_ref(a_u, a_c, a_f, a_dia, omega=OMEGA, spacing=SP), a_u),
            }
            for a, b in CHEB:
                ku, kd = cheb_cuda(a_u, a_c, a_f, a_dia, None if a is None else a_d, a=a, b=b,
                                   h2=H2)
                ru, rd = cheb_sweep_ref(a_u, a_c, a_f, a_dia, a_d, a=a, b=b, spacing=SP)
                pairs[f"cheb(a={a}) u"] = (ku, ru, a_u)
                pairs[f"cheb(a={a}) d"] = (kd, rd, 0)
            torch.cuda.synchronize()
            assert [k.launches for k in (apply_cuda, residual_cuda, jacobi_cuda, cheb_cuda)] \
                == [n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3] + 2]
            for name, (got, want, ring_value) in pairs.items():
                assert got.shape == a_u.shape and got.dtype == dtype and got.is_contiguous()
                _normwise(got, want, tol, name)
                want_ring = ring_value[ring] if torch.is_tensor(ring_value) else \
                    torch.zeros_like(got[ring])
                assert torch.equal(got[ring], want_ring), f"{name}: ring not bitwise"


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    u = torch.rand(8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        apply_op(u.half(), u.half(), spacing=SP)     # no quiet fallback under auto
    with pytest.raises(ValueError):
        apply_op(u.bfloat16(), u.bfloat16(), spacing=SP)
    with pytest.raises(ValueError):
        residual_op(u[0], u[0], u[0], spacing=SP[:2])
    with pytest.raises(ValueError):
        jacobi_sweep(u, u, u, u.double(), omega=OMEGA, spacing=SP)
    with pytest.raises(ValueError):
        cheb_sweep(u, u, u, u[:4], u, a=0.3, b=0.9, spacing=SP)
    with pytest.raises(ValueError):
        apply_op(u, u.cpu(), spacing=SP)
