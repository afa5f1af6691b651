"""The Helmholtz shift of the port's center solver operators (K2-K5 and their
plain versions) against the JAX package.

``A u = shift * u - div(c grad u)``: the reference spells the shift only in
``kernels/solver3d/ref.py::poisson_stencil(shift=)``; its residual and
smoother sweeps with a shift are the closures of
``solvers/multigrid.py::make_v_cycle`` (``f - A u`` on the interior,
``u + omega * r / dia``, the Chebyshev step), whose diagonal already holds
the shift.  The child process spells those from the reference's
``poisson_stencil`` and ``poisson_diag``; the port's plain versions
(``ref.*_ref(shift=)``, and ``ops`` on a CPU tensor) are held to them,
f32 to 1e-6 and f64 to 1e-12 (rtol = atol: the same expressions, rounded at
different places by the two frameworks).

Also against the reference: one application of the shifted
``CyclePreconditioner`` (``helmholtz_shift=True``, Jacobi and Chebyshev) on
8 blocks of an 18^3 grid, f64, to 1e-12 of the field's largest value.

On the CPU: a face location with a shift raises under every
``use_kernel`` and in the kernel wrapper itself; a shift goes to the kernel
where the kernel runs (no fallback to the plain version).  On the card
(``cuda`` marker): each shifted kernel against its plain version at a few
shapes and strided views, normwise as the unshifted kernels
(``tests/test_torch_solver3d.py``), the ring bitwise, the shifted launches
counted; a zero shift gives the unshifted kernels' output bitwise.
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
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.solver3d import kernel as sk  # noqa: E402
from repro_torch.kernels.solver3d import ops, ref  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

SP = (0.5, 0.7, 1.1)
H2 = tuple(float(s) ** 2 for s in SP)
OMEGA = 6.0 / 7.0
CHEB = ((None, 1.25), (0.3, 0.9))     # (a, b): the first step, then a later one
SHAPES = [(8, 8, 8), (12, 6, 8), (16, 10, 12)]
DTYPES = {"float32": (torch.float32, 1e-6), "float64": (torch.float64, 1e-12)}
OUTS = ("apply", "residual", "jacobi", "cheb0_u", "cheb0_d", "cheb1_u", "cheb1_d")
PRECOND = ("jacobi", "chebyshev")
N_GLOBAL = 18
SPACING = (1 / 17, 1 / 17, 1 / 17)

REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.core import init_global_grid
from repro.kernels.solver3d import ref as R
from repro.solvers import CyclePreconditioner

TMP = {tmp!r}
SP, OMEGA, CHEB = {sp!r}, {omega!r}, {cheb!r}
I = (slice(1, -1),) * 3
for i in range({n}):
    for dt in ("float32", "float64"):
        u, c, f, d0, s = (jnp.asarray(np.load(f"{{TMP}}/{{n}}{{i}}.npy"), dt) for n in "ucfds")
        # make_v_cycle's shifted closures: the diagonal holds the shift
        dia = R.poisson_diag(c, SP) + s[I]
        Au = R.poisson_stencil(u, c, SP, shift=s)
        r = jnp.zeros_like(u).at[I].set(f[I] - Au[I])
        outs = [Au, r, u.at[I].add(OMEGA * r[I] / dia)]
        for a, b in CHEB:
            z = r[I] / dia
            dn = z / b if a is None else a * d0[I] + b * z
            outs += [u.at[I].add(dn), jnp.zeros_like(d0).at[I].set(dn)]
        np.save(f"{{TMP}}/ref_{{i}}_{{dt}}.npy",
                np.stack([np.asarray(o, np.float64) for o in outs]))

g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=jnp.float64)
C, S, R_ = (g.scatter(np.load(f"{{TMP}}/{{n}}_global.npy")) for n in "CSR")
for smoother in {precond!r}:
    P = CyclePreconditioner(g, {spacing!r}, helmholtz_shift=True, smoother=smoother)
    sm = jax.shard_map(lambda c, s, r: P.setup(c, s)(r), mesh=g.mesh,
                       in_specs=(g.spec,) * 3, out_specs=g.spec, check_vma=False)
    np.save(f"{{TMP}}/precond_{{smoother}}.npy", np.asarray(jax.jit(sm)(C, S, R_)))
print("OK")
"""


def _global_fields():
    """Coefficient, shift and residual on the 18^3 grid (the residual zero
    on the Dirichlet ring, as CG hands it to the preconditioner)."""
    rng = np.random.RandomState(11)
    C = 1.0 + 0.5 * rng.rand(N_GLOBAL, N_GLOBAL, N_GLOBAL)
    S = 100.0 + 500.0 * rng.rand(N_GLOBAL, N_GLOBAL, N_GLOBAL)
    R = np.zeros((N_GLOBAL,) * 3)
    R[1:-1, 1:-1, 1:-1] = rng.rand(*(N_GLOBAL - 2,) * 3) - 0.5
    return C, S, R


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_solver3d_shift")
    rng = np.random.RandomState(5)
    for i, shape in enumerate(SHAPES):
        for n in "ucfds":
            v = rng.rand(*shape)
            np.save(tmp / f"{n}{i}.npy", v + 0.5 if n == "c" else 10.0 + 40.0 * v if n == "s"
                    else v)
    for n, v in zip("CSR", _global_fields()):
        np.save(tmp / f"{n}_global.npy", v)
    run(REFERENCE.format(tmp=str(tmp), sp=SP, omega=OMEGA, cheb=CHEB, n=len(SHAPES),
                         precond=PRECOND, spacing=SPACING), ndev=8)
    return tmp


def _inputs(tmp, i, dtype):
    return tuple(torch.from_numpy(np.load(tmp / f"{n}{i}.npy")).to(dtype) for n in "ucfds")


def _shifted_dia(c, s):
    """The smoothers' full-shape diagonal with the shift inside (as
    ``make_v_cycle`` builds it)."""
    dia = ref.full_diag(c, SP)
    dia[..., 1:-1, 1:-1, 1:-1] += s[..., 1:-1, 1:-1, 1:-1]
    return dia


def _outputs(u, c, f, d0, s, *, apply, residual, jacobi, cheb):
    dia = _shifted_dia(c, s)
    outs = [apply(u, c, SP, shift=s), residual(u, c, f, SP, shift=s),
            jacobi(u, c, f, dia, omega=OMEGA, spacing=SP, shift=s)]
    for a, b in CHEB:
        outs += list(cheb(u, c, f, dia, d0, a=a, b=b, spacing=SP, shift=s))
    return outs


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_shifted_plain_versions_vs_reference(reference, i, dt):
    dtype, tol = DTYPES[dt]
    inputs = _inputs(reference, i, dtype)
    plain = _outputs(*inputs, apply=ref.apply_op_ref, residual=ref.residual_op_ref,
                     jacobi=ref.jacobi_sweep_ref, cheb=ref.cheb_sweep_ref)
    via_ops = _outputs(
        *inputs,
        apply=lambda u, c, sp, shift: ops.apply_op(u, c, spacing=sp, shift=shift),
        residual=lambda u, c, f, sp, shift: ops.residual_op(u, c, f, spacing=sp, shift=shift),
        jacobi=ops.jacobi_sweep, cheb=ops.cheb_sweep)
    want = np.load(reference / f"ref_{i}_{dt}.npy")
    for k, name in enumerate(OUTS):
        assert plain[k].dtype == dtype and plain[k].shape == inputs[0].shape
        np.testing.assert_allclose(plain[k].double().numpy(), want[k], rtol=tol, atol=tol,
                                   err_msg=name)
        assert torch.equal(via_ops[k], plain[k]), name   # auto on a CPU tensor: the plain version
    # the shift changes the operator: the check is not an unshifted one
    assert not torch.allclose(plain[0], ref.apply_op_ref(*inputs[:2], SP))


@pytest.mark.parametrize("smoother", PRECOND)
def test_shifted_cycle_preconditioner_vs_reference(reference, smoother):
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device="cpu")
    C, S, R = (g.scatter(v) for v in _global_fields())
    P = solvers.CyclePreconditioner(g, SPACING, helmholtz_shift=True, smoother=smoother)
    z = P.setup(C, S)(R)
    want = np.load(reference / f"precond_{smoother}.npy")
    np.testing.assert_allclose(g.to_stacked(z), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # without the shift the cycle is a different operator's
    z0 = solvers.CyclePreconditioner(g, SPACING, smoother=smoother).setup(C)(R)
    assert np.abs(g.to_stacked(z0) - want).max() > 1e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="second operator arg"):
        P.setup(C)


@pytest.mark.parametrize("use_kernel", list(dispatch.MODES))
def test_face_shift_raises_under_every_mode(use_kernel, monkeypatch):
    u = torch.rand(2, 8, 8, 8, dtype=torch.float64)
    m = torch.ones_like(u)
    for where in ("cpu", "kernel"):
        if where == "kernel":   # as where a CUDA tensor would launch the kernel
            monkeypatch.setattr(dispatch, "resolve",
                                lambda mode, x, where="": "ref" if mode == "ref" else "cuda")
        with pytest.raises(ValueError, match="center only"):
            ops.resolve(use_kernel, u, SP, loc="xface", shift=u, imask=m)
        with pytest.raises(ValueError, match="center only"):
            ops.apply_op(u, u, spacing=SP, loc="yface", shift=u, use_kernel=use_kernel)
        with pytest.raises(ValueError, match="center only"):
            ops.jacobi_sweep(u, u, u, u, omega=OMEGA, spacing=SP, loc="zface", shift=u, imask=m,
                             use_kernel=use_kernel)
    # the wrapper itself refuses a shift on a face location
    with pytest.raises(ValueError, match="center only"):
        sk._launch("apply", u, u, s=u, sd=0, h2=H2)


def test_shift_goes_to_the_kernel_where_it_runs(monkeypatch):
    """With the kernel selected, a shifted op calls the kernel wrapper (which
    raises here, the tensor being on the CPU) and never the plain version."""
    monkeypatch.setattr(dispatch, "resolve",
                        lambda mode, x, where="": "ref" if mode == "ref" else "cuda")
    u = torch.rand(1, 8, 8, 8, dtype=torch.float64)
    dia = _shifted_dia(u + 0.5, u)
    n0 = [k.launches for k in sk.WRAPPERS[:4]]
    for call in (lambda: ops.apply_op(u, u, spacing=SP, shift=u),
                 lambda: ops.residual_op(u, u, u, spacing=SP, shift=u),
                 lambda: ops.jacobi_sweep(u, u, u, dia, omega=OMEGA, spacing=SP, shift=u),
                 lambda: ops.cheb_sweep(u, u, u, dia, u, a=None, b=1.0, spacing=SP, shift=u),
                 lambda: solvers.poisson_apply(None, u, u, SP, update_halo=False, shift=u)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert [k.launches for k in sk.WRAPPERS[:4]] == n0
    # a 2-D grid still raises where the kernel would run
    with pytest.raises(ValueError, match="3-D"):
        ops.resolve("auto", u, SP[:2], shift=u)
    assert ops.apply_op(u, u, spacing=SP, shift=u, use_kernel="ref").shape == u.shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_outputs(u, c, f, d0, s, dia):
    outs = [sk.apply_cuda(u, c, h2=H2, shift=s), sk.residual_cuda(u, c, f, h2=H2, shift=s),
            sk.jacobi_cuda(u, c, f, dia, omega=OMEGA, h2=H2, shift=s)]
    for a, b in CHEB:
        outs += list(sk.cheb_cuda(u, c, f, dia, None if a is None else d0, a=a, b=b, h2=H2,
                                  shift=s))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_shifted_kernels_vs_plain_on_card(cuda_device, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.RandomState(9)
    for shape in [(1, 10, 10, 10), (8, 34, 18, 66), (2, 2, 2, 18, 10, 34)]:
        u, c, f, d0 = (torch.from_numpy(rng.rand(*shape) + 0.5).to(cuda_device, dtype)
                       for _ in range(4))
        s = torch.from_numpy(10.0 + 40.0 * rng.rand(*shape)).to(cuda_device, dtype)
        dia = _shifted_dia(c, s)
        for sl in (np.s_[...], np.s_[..., 1:8, :, 3:9]):   # whole blocks, strided views
            args = tuple(t[sl] for t in (u, c, f, d0, s, dia))
            a_u = args[0]
            n0 = [(k.launches, k.shifted_launches) for k in sk.WRAPPERS[:4]]
            got = _kernel_outputs(*args)
            torch.cuda.synchronize()
            assert [(k.launches, k.shifted_launches) for k in sk.WRAPPERS[:4]] == \
                [(n + m, ns + m) for (n, ns), m in zip(n0, (1, 1, 1, 2))]
            want = _outputs(*args[:5], apply=ref.apply_op_ref, residual=ref.residual_op_ref,
                            jacobi=ref.jacobi_sweep_ref, cheb=ref.cheb_sweep_ref)
            r = torch.ones(a_u.shape[-3:], dtype=torch.bool, device=cuda_device)
            r[1:-1, 1:-1, 1:-1] = False
            r = r.expand(a_u.shape)
            for name, g_, w in zip(OUTS, got, want):
                assert g_.shape == a_u.shape and g_.dtype == dtype and g_.is_contiguous()
                err = (g_.double() - w.double()).abs().max().item()
                assert err <= tol * max(w.double().abs().max().item(), 1.0), (name, err)
                ring_value = a_u if name in ("jacobi", "cheb0_u", "cheb1_u") else 0.0 * a_u
                assert torch.equal(g_[r], ring_value[r]), f"{name}: ring not bitwise"
            # a zero shift is the unshifted operator, bitwise
            zero = _kernel_outputs(*args[:4], torch.zeros_like(args[4]), ref.full_diag(
                args[1], SP))
            plain = [sk.apply_cuda(a_u, args[1], h2=H2),
                     sk.residual_cuda(a_u, args[1], args[2], h2=H2),
                     sk.jacobi_cuda(a_u, args[1], args[2], ref.full_diag(args[1], SP),
                                    omega=OMEGA, h2=H2)]
            for a, b in CHEB:
                plain += list(sk.cheb_cuda(a_u, args[1], args[2], ref.full_diag(args[1], SP),
                                           None if a is None else args[3], a=a, b=b, h2=H2))
            for name, z, p in zip(OUTS, zero, plain):
                assert torch.equal(z, p), f"{name}: zero shift differs from no shift"


@pytest.mark.cuda
def test_shifted_cycle_on_card_counts_shifted_launches(cuda_device):
    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64, device=cuda_device)
    C, S, R = (g.scatter(v) for v in _global_fields())
    P = solvers.CyclePreconditioner(g, SPACING, helmholtz_shift=True)
    n0 = [(k.launches, k.shifted_launches) for k in sk.WRAPPERS[:4]]
    z = P.setup(C, S)(R)
    torch.cuda.synchronize()
    runs = [(k.launches - a, k.shifted_launches - b) for k, (a, b) in zip(sk.WRAPPERS[:4], n0)]
    assert all(n == ns for n, ns in runs) and runs[1][0] > 0 and runs[2][0] > 0
    z_ref = solvers.CyclePreconditioner(g, SPACING, helmholtz_shift=True,
                                        use_kernel="ref").setup(C, S)(R)
    err = (z - z_ref).abs().max().item()
    assert err <= 1e-12 * z_ref.abs().max().item(), err
