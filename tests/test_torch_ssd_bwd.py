"""K7's backward (``kernels/ssd/csrc/ssd_bwd.cu``) and the SSD's autograd
route: the plain version, the route through ``_SsdCuda``, the launch plans
and the contract, on the CPU; the kernel itself on the card (marker
``cuda``).

* ``ssd_intra_chunk_backward_ref`` (products written out) against
  ``torch.autograd.grad`` of ``ssd_intra_chunk_ref``, with ``s`` a leaf of
  its own (the direct ddt and ds) and through ``chunk_logdecay`` (dt and
  A), at G 1, 2 and H and ragged L (5, 1, 50): 1e-5 normwise (float32 both,
  the same products in another order).
* The CUDA route with K7's wrappers replaced by their counting plain
  versions: ``ssd_scan``'s gradients for x, dt, A, B, C and h0 against
  ``jax.vjp`` of the reference's ``ssd_chunked_ref`` (through its
  ``ssd_scan(use_kernel="ref")``, the same chunk rule), run in a child
  process: 1e-5 normwise (float32 in both frameworks, other summation
  orders); K7's launches a training step under each remat policy.
* The backward's launch plan under an analyzer check, in the analyzer's
  library, and the wrapper's raises.
* On the card: the kernel against the plain version at 1e-5 normwise for
  each of dx, ddt, ds, dB, dC, two runs bitwise (no atomics), and the
  route's gradients against use_kernel="ref".
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.analysis import launchgrid  # noqa: E402
from repro_torch.analysis.trace import Trace  # noqa: E402
from repro_torch.configs import mamba2_1p3b  # noqa: E402
from repro_torch.data import SyntheticLMData, synthetic_batch  # noqa: E402
from repro_torch.kernels import dispatch, plans  # noqa: E402
from repro_torch.kernels.ssd import kernel as kssd  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
# the wrapper itself: the cuda_route fixture replaces kssd.ssd_backward_cuda
from repro_torch.kernels.ssd.kernel import ssd_backward_cuda  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import TrainCfg, make_train_step  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
TOL = 1e-5
NAMES = ("dx", "ddt", "ds", "dB", "dC")
# Ba, T, H, P, N, G, L
BWD_CASES = ((2, 32, 4, 8, 16, 1, 8), (2, 32, 4, 8, 16, 2, 8), (2, 32, 4, 8, 16, 4, 8),
             (2, 40, 4, 8, 16, 2, 5), (2, 3, 4, 8, 8, 1, 1), (1, 50, 2, 8, 12, 1, 50))
# T, chunk asked for, G, with h0 (the chunk rule makes L 8, 10, 17 and 4)
SCAN_CASES = ((32, 8, 1, True), (40, 16, 2, True), (17, 64, 1, False), (16, 4, 4, False))
SCAN_DIMS = (2, 4, 8, 16)   # Ba, H, P, N

REFERENCE = ALIAS + """
from repro.kernels.ssd import ops

TMP = {tmp!r}
for i, (T, chunk, G, with_h0) in enumerate({cases!r}):
    a = np.load(f"{{TMP}}/scan_{{i}}.npz")
    ins = [jnp.asarray(a[n]) for n in ("x", "dt", "A", "B", "C")]
    if with_h0:
        ins.append(jnp.asarray(a["h0"]))

    def f(*args):
        h0 = args[5] if len(args) > 5 else None
        return ops.ssd_scan(*args[:5], chunk=chunk, use_kernel="ref", h0=h0)

    (y, h), vjp = jax.vjp(f, *ins)
    grads = vjp((jnp.asarray(a["dy"]), jnp.asarray(a["dh"])))
    np.savez(f"{{TMP}}/scan_out_{{i}}.npz", y=np.asarray(y), h=np.asarray(h),
             **{{n: np.asarray(g) for n, g in zip(("x", "dt", "A", "B", "C", "h0"), grads)}})
print("OK")
"""


def _normwise(got, want, what):
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - want).ravel())
    assert np.isfinite(got).all() and err <= TOL * np.linalg.norm(want.ravel()) + 1e-12, \
        (what, err, np.linalg.norm(want.ravel()))


def _inputs(rng, Ba, T, H, P, N, G):
    x = rng.randn(Ba, T, H, P).astype(np.float32)
    dt = (rng.rand(Ba, T, H) * 0.2 + 0.01).astype(np.float32)
    A = (-rng.rand(H) - 0.1).astype(np.float32)
    B = (rng.randn(Ba, T, G, N) * 0.4).astype(np.float32)
    C = (rng.randn(Ba, T, G, N) * 0.4).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A, B, C)]


def _cotangents(rng, Ba, T, H, P, N, L):
    return (torch.from_numpy(rng.randn(Ba, T, H, P).astype(np.float32)),
            torch.from_numpy(rng.randn(Ba, T // L, H, N, P).astype(np.float32)))


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_ref_is_the_gradient_of_the_forward(case, monkeypatch):
    Ba, T, H, P, N, G, L = case
    rng = np.random.RandomState(sum(case))
    x, dt, A, B, C = (t.requires_grad_(True) for t in _inputs(rng, Ba, T, H, P, N, G))
    dy, dS = _cotangents(rng, Ba, T, H, P, N, L)
    s = ssd_ref.chunk_logdecay(dt, A, L)
    got = ssd_ref.ssd_intra_chunk_backward_ref(x.detach(), dt.detach(), s.detach(), B.detach(),
                                               C.detach(), dy, dS)
    assert [g.shape for g in got] == [x.shape, dt.shape, s.shape, B.shape, C.shape]
    # s a leaf of its own: the direct ddt and ds
    s_leaf = s.detach().requires_grad_(True)
    with monkeypatch.context() as m:
        m.setattr(ssd_ref, "chunk_logdecay", lambda *a: s_leaf)
        y, st, _ = ssd_ref.ssd_intra_chunk_ref(x, dt, A, B, C, chunk=L)
        want = torch.autograd.grad((y, st), (x, dt, s_leaf, B, C), (dy, dS))
    for name, g, w in zip(NAMES, got, want):
        _normwise(g, w, name)
    # through chunk_logdecay: dt and A
    y, st, _ = ssd_ref.ssd_intra_chunk_ref(x, dt, A, B, C, chunk=L)
    want_dt, want_A = torch.autograd.grad((y, st), (dt, A), (dy, dS))
    chain_dt, chain_A = torch.autograd.grad(s, (dt, A), got[2])
    _normwise(got[1] + chain_dt, want_dt, "dt")
    if L > 1:   # at L = 1 nothing of the block depends on A
        _normwise(chain_A, want_A, "A")


# ---------------------------------------------------------------------------
# the CUDA route, K7 standing in by its plain versions
# ---------------------------------------------------------------------------

class _Counting:
    """K7's wrappers replaced by plain versions that count their calls."""

    def __init__(self):
        self.fwd = self.bwd = 0

    def forward(self, *args, s=None, **kw):   # the plain version recomputes s
        self.fwd += 1
        return ssd_ref.ssd_intra_chunk_ref(*args, **kw)

    def backward(self, *args):
        self.bwd += 1
        return ssd_ref.ssd_intra_chunk_backward_ref(*args)


@pytest.fixture
def cuda_route(monkeypatch):
    """``dispatch.resolve`` says "cuda" (but "ref" for "ref"), and K7's
    wrappers are the counting plain versions."""
    monkeypatch.setattr(dispatch, "resolve",
                        lambda use_kernel, x, where="": "ref" if use_kernel == "ref" else "cuda")
    fake = _Counting()
    monkeypatch.setattr(kssd, "ssd_intra_chunk_cuda", fake.forward)
    monkeypatch.setattr(kssd, "ssd_backward_cuda", fake.backward)
    return fake


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ssd_bwd")
    Ba, H, P, N = SCAN_DIMS
    rng = np.random.RandomState(5)
    for i, (T, chunk, G, _) in enumerate(SCAN_CASES):
        x, dt, A, B, C = (t.numpy() for t in _inputs(rng, Ba, T, H, P, N, G))
        np.savez(tmp / f"scan_{i}.npz", x=x, dt=dt, A=A, B=B, C=C,
                 h0=(rng.randn(Ba, H, N, P) * 0.3).astype(np.float32),
                 dy=rng.randn(Ba, T, H, P).astype(np.float32),
                 dh=rng.randn(Ba, H, N, P).astype(np.float32))
    run(REFERENCE.format(tmp=str(tmp), cases=SCAN_CASES), ndev=1)
    return tmp


@pytest.mark.parametrize("i", range(len(SCAN_CASES)),
                         ids=[f"T{T}-chunk{c}-G{G}-h0{h}" for T, c, G, h in SCAN_CASES])
def test_scan_gradients_on_the_cuda_route_vs_jax_vjp(reference, cuda_route, i):
    T, chunk, G, with_h0 = SCAN_CASES[i]
    a = np.load(reference / f"scan_{i}.npz")
    want = np.load(reference / f"scan_out_{i}.npz")
    names = ("x", "dt", "A", "B", "C") + (("h0",) if with_h0 else ())
    ins = [torch.from_numpy(a[n]).requires_grad_(True) for n in names]
    h0 = ins[5] if with_h0 else None
    y, h = ssd_ops.ssd_scan(*ins[:5], chunk=chunk, h0=h0)
    assert (cuda_route.fwd, cuda_route.bwd) == (1, 0) and y.grad_fn is not None
    _normwise(y.detach(), want["y"], "y")
    _normwise(h.detach(), want["h"], "h")
    grads = torch.autograd.grad((y, h), ins, (torch.from_numpy(a["dy"]), torch.from_numpy(a["dh"])))
    assert (cuda_route.fwd, cuda_route.bwd) == (1, 1)
    for n, g in zip(names, grads):
        _normwise(g, want[n], n)


@pytest.mark.parametrize("remat, per_layer", (("full", 2), ("dots", 2), ("none", 1)))
def test_k7_launches_per_step_under_each_remat(cuda_route, remat, per_layer):
    """A checkpointed Mamba layer runs K7's forward again in the backward:
    two forward launches a layer under "full" and "dots" (K7 is no matmul),
    one under "none"; one backward launch a layer."""
    cfg = dataclasses.replace(mamba2_1p3b.SMOKE, dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(SyntheticLMData(cfg.vocab, 2, 16, device="cpu"), 0)
    step = make_train_step(cfg, TrainCfg(remat=remat, warmup=1, total_steps=5))
    _, _, m = step(params, optim.init(params, optim.AdamWCfg(),
                                      layout=tf.reference_layout(cfg)), batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert (cuda_route.fwd, cuda_route.bwd) == (per_layer * cfg.n_layers, cfg.n_layers)


# ---------------------------------------------------------------------------
# launch plan and contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", plans._SSD_BWD_SHAPES)
def test_backward_plan_covers_its_output(shape):
    Ba, T, H, G, L = shape
    plan = plans.ssd_bwd_plan(Ba, T, H, G, L)
    assert launchgrid.check_plan(plan) == []
    # the forward's plan: HS heads of one group per block of two warpgroups
    hs = plan.tile[2]
    assert plan == dataclasses.replace(plans.ssd_plan(False, Ba, T, H, G, L), kernel="K7b ssd_bwd")
    assert (H // G) % hs == 0 and plan.block == (256, 1, 1)
    assert plan.grid == (Ba * (T // L) * H // hs, 1, 1)
    assert (f"K7b[{Ba}x{T}x{H},G={G},L={L}]", plan) in plans.library_plans()


def test_backward_records_its_plan_under_a_check_and_launches_nothing():
    Ba, T, H, P, N, G, L = 2, 40, 8, 16, 16, 2, 8
    x, dy = torch.zeros(Ba, T, H, P), torch.zeros(Ba, T, H, P)
    dt, B, C = torch.zeros(Ba, T, H), torch.zeros(Ba, T, G, N), torch.zeros(Ba, T, G, N)
    s, dS = torch.zeros(Ba, T // L, L, H), torch.zeros(Ba, T // L, H, N, P)
    before = kssd.ssd_backward_cuda.launches
    trace = Trace(device_type="cuda")
    with trace.recording([x, dt, s, B, C, dy, dS]):
        out = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    assert trace.launches == [plans.ssd_bwd_plan(Ba, T, H, G, L)]
    assert [o.shape for o in out] == [x.shape, dt.shape, s.shape, B.shape, C.shape]
    assert kssd.ssd_backward_cuda.launches == before


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda_route):
    Ba, T, H, P, N, G, L = 1, 16, 4, 8, 8, 1, 8
    x, dt, A, B, C = _inputs(np.random.RandomState(0), Ba, T, H, P, N, G)
    s = ssd_ref.chunk_logdecay(dt, A, L)
    dy, dS = _cotangents(np.random.RandomState(1), Ba, T, H, P, N, L)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    where = "ssd_backward_cuda"
    with pytest.raises(ValueError, match="chunk L=3"):
        kssd.check_args(x, dt, None, B, C, 3, where)
    with pytest.raises(ValueError, match="multiples of 4"):
        kssd.check_args(x[..., :6], dt, None, B, C, L, where)
    with pytest.raises(ValueError, match="shapes disagree"):
        kssd.check_args(x, dt[:, :8], None, B, C, L, where)
    # bfloat16 with gradients wanted: the backward kernel is float32
    xb, Bb, Cb = (t.bfloat16().requires_grad_(True) for t in (x, B, C))
    with pytest.raises(NotImplementedError, match="float32"):
        ssd_ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=L)
    with torch.no_grad():   # serving in bfloat16 stays on the forward kernel
        ssd_ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=L)
    assert (cuda_route.fwd, cuda_route.bwd) == (1, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_CASES = ((4, 2048, 64, 64, 128, 1, 64), (1, 1000, 64, 64, 128, 1, 50),
              (2, 64, 8, 16, 16, 2, 8), (2, 20, 8, 16, 16, 8, 5), (2, 7, 4, 8, 4, 1, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(case, dev, seed=0):
    """x, B, C as slices of one projection (the Mamba layer's views)."""
    Ba, T, H, P, N, G, L = case
    g = torch.Generator(device=dev).manual_seed(seed)
    w = H * P + 2 * G * N
    zx = torch.randn(Ba, T, w, generator=g, device=dev)
    x = zx[..., :H * P].view(Ba, T, H, P)
    B = zx[..., H * P:H * P + G * N].view(Ba, T, G, N)
    C = zx[..., H * P + G * N:].view(Ba, T, G, N)
    dt = torch.nn.functional.softplus(torch.randn(Ba, T, H, generator=g, device=dev) - 2.0)
    A = -torch.exp(torch.rand(H, generator=g, device=dev))
    dy = torch.randn(Ba, T, H, P, generator=g, device=dev)
    dS = torch.randn(Ba, T // L, H, N, P, generator=g, device=dev)
    return x, dt, A, B, C, dy, dS


def _frobenius(got, want):
    """||got - want|| / ||want||; the difference's norm where want is 0 (ds
    at L = 1, where every term cancels)."""
    d, w = (float(torch.linalg.vector_norm(t)) for t in (got - want, want))
    return d / w if w > 0 else d


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_kernel_vs_plain_on_card(cuda_device, case):
    x, dt, A, B, C, dy, dS = _card_inputs(case, cuda_device)
    s = ssd_ref.chunk_logdecay(dt, A, case[-1])
    n0 = kssd.ssd_backward_cuda.launches
    got = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    again = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    torch.cuda.synchronize()
    assert kssd.ssd_backward_cuda.launches == n0 + 2
    want = ssd_ref.ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dS)
    for name, a, b, c in zip(NAMES, got, want, again):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a).all(), name
        assert _frobenius(a, b) <= TOL, (name, _frobenius(a, b))
        assert torch.equal(a, c), name   # no atomics


@pytest.mark.cuda
def test_autograd_route_on_card(cuda_device):
    case = (2, 128, 8, 16, 16, 2, 16)
    x, dt, A, B, C, dy, _ = _card_inputs(case, cuda_device, seed=3)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    h0 = torch.randn(2, 8, 16, 16, device=cuda_device, requires_grad=True)
    f0, b0 = kssd.ssd_intra_chunk_cuda.launches, kssd.ssd_backward_cuda.launches
    y, h = ssd_ops.ssd_scan(*ins, chunk=16, h0=h0)
    dh = torch.randn_like(h)
    got = torch.autograd.grad((y, h), ins + [h0], (dy, dh))
    assert (kssd.ssd_intra_chunk_cuda.launches - f0, kssd.ssd_backward_cuda.launches - b0) == (1, 1)
    y2, h2 = ssd_ops.ssd_scan(*ins, chunk=16, h0=h0, use_kernel="ref")
    want = torch.autograd.grad((y2, h2), ins + [h0], (dy, dh))
    for name, a, b in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        assert _frobenius(a, b) <= TOL, (name, _frobenius(a, b))
