"""The heat step of the port (K1's plain version and dispatch) against the
JAX package's ``heat_step_ref`` and ``heat_step_pallas(..., interpret=True)``.

Shapes and block sizes are those of ``tests/test_kernel_stencil3d.py``, in
f32, bf16 and f64.  The reference runs once in a module-scoped child
process; arrays travel as ``.npy`` files made from a numpy seed.  The CUDA
kernel itself runs only on a card: those tests carry the ``cuda`` marker.
Tolerances (rtol = atol): f32 1e-6, bf16 2e-2, f64 1e-12 — the two
frameworks round the same expression at different places.
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
from repro_torch.kernels.stencil3d import heat_step, heat_step_cuda, heat_step_ref  # noqa: E402
from repro_torch.stencil import fd3d as fd  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

SHAPES = [((8, 8, 8), 4), ((16, 10, 12), 8), ((32, 6, 6), 8), ((8, 24, 16), 2)]
DTYPES = {"float32": (torch.float32, 1e-6), "bfloat16": (torch.bfloat16, 2e-2),
          "float64": (torch.float64, 1e-12)}
COEFS = (1.3, 0.01, 0.7, 0.9, 1.1)   # lam, dt, dx, dy, dz

REFERENCE = ALIAS + """
jax.config.update("jax_enable_x64", True)
from repro.kernels.stencil3d import heat_step_ref
from repro.kernels.stencil3d.kernel import heat_step_pallas

TMP = {tmp!r}
for i, (shape, bx) in enumerate({shapes!r}):
    for dt in ("float32", "bfloat16", "float64"):
        T = jnp.asarray(np.load(f"{{TMP}}/T{{i}}.npy"), dt)
        Ci = jnp.asarray(np.load(f"{{TMP}}/C{{i}}.npy"), dt)
        args = (T, Ci) + {coefs!r}
        np.save(f"{{TMP}}/ref_{{i}}_{{dt}}.npy", np.asarray(heat_step_ref(*args), np.float64))
        np.save(f"{{TMP}}/pallas_{{i}}_{{dt}}.npy", np.asarray(
            heat_step_pallas(*args, bx=bx, interpret=True), np.float64))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stencil3d")
    rng = np.random.RandomState(0)
    for i, (shape, _) in enumerate(SHAPES):
        np.save(tmp / f"T{i}.npy", rng.rand(*shape))
        np.save(tmp / f"C{i}.npy", rng.rand(*shape))
    run(REFERENCE.format(tmp=str(tmp), shapes=SHAPES, coefs=COEFS), ndev=1)
    return tmp


def _inputs(tmp, i, dtype):
    return (torch.from_numpy(np.load(tmp / f"T{i}.npy")).to(dtype),
            torch.from_numpy(np.load(tmp / f"C{i}.npy")).to(dtype))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_heat_step_ref_vs_jax_ref_and_pallas(reference, i, dt):
    dtype, tol = DTYPES[dt]
    T, Ci = _inputs(reference, i, dtype)
    got = heat_step(T, Ci, *COEFS)   # auto on a CPU tensor: the plain version
    assert got.dtype == dtype and got.shape == T.shape
    g = got.double().numpy()
    for kind in ("ref", "pallas"):
        want = np.load(reference / f"{kind}_{i}_{dt}.npy")
        np.testing.assert_allclose(g, want, rtol=tol, atol=tol, err_msg=kind)
        # the ring passes through bit for bit
        for ax in range(3):
            for idx in (0, -1):
                np.testing.assert_array_equal(np.take(g, idx, ax), np.take(want, idx, ax))


def test_heat_step_batched_equals_per_block():
    rng = np.random.RandomState(4)
    T = torch.from_numpy(rng.rand(2, 3, 9, 7, 8))
    Ci = torch.from_numpy(rng.rand(2, 3, 9, 7, 8))
    out = heat_step_ref(T, Ci, *COEFS)
    for a in range(2):
        for b in range(3):
            assert torch.equal(out[a, b], heat_step_ref(T[a, b], Ci[a, b], *COEFS))
    # a strided slab view gives the same cells as the slab of a copy
    v = T[:, :, 2:8, :, 1:7]
    assert torch.equal(heat_step_ref(v, Ci[:, :, 2:8, :, 1:7], *COEFS),
                       heat_step_ref(v.contiguous(), Ci[:, :, 2:8, :, 1:7].contiguous(), *COEFS))


def test_heat_step_ref_is_the_fd3d_quickstart_step():
    rng = np.random.RandomState(6)
    T = torch.from_numpy(rng.rand(6, 7, 8))
    Ci = torch.from_numpy(rng.rand(6, 7, 8))
    lam, dt = 1.0, 0.1
    got = heat_step_ref(T, Ci, lam, dt, 1.0, 1.0, 1.0)
    Tn = fd.inn(T) + dt * (lam * fd.inn(Ci) * (fd.d2_xi(T) + fd.d2_yi(T) + fd.d2_zi(T)))
    np.testing.assert_allclose(fd.inn(got).numpy(), Tn.numpy(), rtol=1e-14, atol=1e-14)
    assert fd.d_xa(T).shape == (5, 7, 8) and fd.av(T).shape == (5, 6, 7)
    assert fd.maxloc(T).shape == (4, 5, 6)


def test_dispatch_contract():
    T = torch.zeros(4, 4, 4)
    assert dispatch.resolve("auto", T) == "ref"
    assert dispatch.resolve("ref", T) == "ref"
    with pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.resolve("cuda", T)
    with pytest.raises(ValueError, match="unknown"):
        dispatch.resolve("pallas", T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.resolve("auto", torch.zeros(4, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        heat_step(T, T, *COEFS, use_kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        heat_step_cuda(T, T, *COEFS)


def test_ops_heat_step_has_no_fallback():
    from repro_torch.kernels.stencil3d import ops

    tree = ast.parse(inspect.getsource(ops))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_heat_step_cuda_vs_ref_on_card(cuda_device, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.RandomState(8)
    for shape in [(8, 8, 8), (8, 34, 18, 66), (2, 2, 2, 40, 36, 34)]:
        T = torch.from_numpy(rng.rand(*shape)).to(cuda_device, dtype)
        Ci = torch.from_numpy(rng.rand(*shape)).to(cuda_device, dtype)
        for a, b in ((T, Ci), (T[..., 3:24, :, 5:30], Ci[..., 3:24, :, 5:30])):
            n0 = heat_step_cuda.launches
            got = heat_step(a, b, *COEFS)
            assert heat_step_cuda.launches == n0 + 1
            want = heat_step_ref(a, b, *COEFS)
            torch.testing.assert_close(got.double(), want.double(), rtol=tol, atol=tol)
            for ax in (-3, -2, -1):
                for idx in (0, a.shape[ax] - 1):
                    assert torch.equal(got.select(ax, idx), a.select(ax, idx))


@pytest.mark.cuda
def test_heat_step_cuda_rejects_what_it_does_not_take(cuda_device):
    T = torch.zeros(8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        heat_step(T.half(), T.half(), *COEFS)   # no silent fallback under auto
    with pytest.raises(ValueError):
        heat_step(T, T[:4], *COEFS)
    with pytest.raises(ValueError):
        heat_step(T[0], T[0], *COEFS)
