"""Why K7's float32 kernels take three TF32 products (3xTF32), and their
launch plans.

K7's float32 forward (``kernels/ssd/csrc/ssd.cu``, ``ssd_chunk_kernel_tf32``)
and its backward (``kernels/ssd/csrc/ssd_bwd.cu``, ``ssd_bwd_dc`` and
``ssd_bwd_dxdb``) run every product on the tensor cores in TF32, which keeps
10 mantissa bits.  A float64 NumPy model rounds where the kernels round
(``tf32``, ``split`` and ``product`` of ``tests/test_torch_swa_tf32.py``:
TF32 as ``cvt.rna``, the big/small split, each product from a zero
accumulator that cuts every sum of 8 products toward zero):

* the scores C B^T (forward), G^T = B C^T and V = B dS (backward) sum N in
  two halves of 64, each one tile product, added in float32;
* W X, the states (u o B)^T X, dW = dY X^T, M B, M^T C, (u o X) dS^T and
  W^T dY are one tile product each (over the chunk's rows or over P), added
  in float32 to their outputs (dC and dB summed over a group's heads in
  order);
* float32 rounded to nearest wherever the CUDA cores work: the decay, W, M,
  P1 and u on the accumulators' fragments (products rounded one by one,
  u_j B_jn and u_j X_jp before the split), dX = W^T dY + u V as one fmaf,
  and the row and column sums of ddt and ds (modelled as float64 sums
  rounded once: their order moves them by far less than the tolerances).

At small cases (L 64, 50, 8, 5 and 1; G 1 and 2; the odd widths N 12 and
120, P 4 and 56 of ``tests/test_torch_ssd.py``) the model lies within 2e-6
of exact float64, inside the card's 1e-5 (``chip_smoke.K7_TOL``,
``K7B_TOL``): normwise (max |err| / max |exact|) for y_diag and the states,
in relative Frobenius norm for the five gradients, ds included.  dB and dC
sum a group's heads, whose terms may cancel; their error is measured
against the size of those terms.  The same model with one TF32 product
per multiply leaves 1e-5: one product cannot meet the tolerances.

On the card (marker ``cuda``): a float32 call counts as a tensor-core
launch, forward and backward within 1e-5 of their plain versions; views at
any alignment give the results of contiguous inputs bitwise.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.analysis import launchgrid  # noqa: E402
from repro_torch.analysis.trace import Trace  # noqa: E402
from repro_torch.kernels import plans  # noqa: E402
from repro_torch.kernels.ssd import kernel as kssd  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from test_torch_swa_tf32 import product, split, tf32  # noqa: E402

F32, F64 = np.float32, np.float64
MODEL_TOL = 2e-6    # the 3xTF32 model against exact float64
CARD_TOL = 1e-5     # chip_smoke.K7_TOL["float32"] and K7B_TOL
FWD_NAMES = ("y_diag", "states")
BWD_NAMES = ("dx", "ddt", "ds", "dB", "dC")

# Ba, T, H, G, N, P, L: mamba2's widths at L 64 and the ragged L 50, two
# groups, the odd widths (N 12 and 120, P 4 and 56), short chunks (8, 5, 1)
CASES = [(1, 64, 2, 1, 128, 64, 64), (1, 100, 2, 1, 128, 64, 50), (2, 16, 4, 2, 16, 16, 8),
         (1, 10, 4, 2, 12, 4, 5), (1, 64, 2, 1, 120, 56, 64), (2, 3, 4, 2, 16, 8, 1)]


def _inputs(case, seed):
    """x, B, C normal; dt as softplus gives it, A = -exp(U(0, 1)) (as
    ``chip_smoke.k7_inputs`` makes them); s the in-chunk cumulative sum of
    dt A in float32; the cotangents dy and dS normal."""
    Ba, T, H, G, N, P, L = case
    rng = np.random.RandomState(seed)
    x = rng.randn(Ba, T, H, P).astype(F32)
    B, C = (rng.randn(Ba, T, G, N).astype(F32) for _ in range(2))
    dt = np.log1p(np.exp(rng.randn(Ba, T, H) - 2.0)).astype(F32)
    A = -np.exp(rng.rand(H)).astype(F32)
    s = np.cumsum((dt * A).reshape(Ba, T // L, L, H), axis=2, dtype=F32)
    dy = rng.randn(Ba, T, H, P).astype(F32)
    dS = rng.randn(Ba, T // L, H, N, P).astype(F32)
    return x, dt, s, B, C, dy, dS


def _exp(a):
    """exp in float32 (float64, rounded once)."""
    return np.exp(a.astype(F64)).astype(F32)


def _halves(a, b, three):
    """a @ b over K in two halves of 64, each a tile product, added in float32."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], F32)
    for k0 in range(0, a.shape[-1], 64):
        out = (out + product(a[..., k0:k0 + 64], b[..., k0:k0 + 64, :], three)).astype(F32)
    return out


def _cells(case, arrays):
    """Per (batch, chunk, group) cell: the chunk's rows of x, dy (L, H, P),
    B, C (L, N), dt (L, H), s (L, H) and dS (H, N, P) of the group's heads."""
    Ba, T, H, G, N, P, L = case
    x, dt, s, B, C, dy, dS = arrays
    R = H // G
    for b in range(Ba):
        for c in range(T // L):
            rows = slice(c * L, (c + 1) * L)
            for g in range(G):
                hs = slice(g * R, (g + 1) * R)
                yield (b, c, g, rows, hs), (x[b, rows, hs], dt[b, rows, hs], s[b, c, :, hs],
                                            B[b, rows, g], C[b, rows, g], dy[b, rows, hs],
                                            dS[b, c, hs])


def forward_model(case, arrays, three=True):
    """The float32 forward: (y_diag, states)."""
    Ba, T, H, G, N, P, L = case
    tri = np.tril(np.ones((L, L), bool))
    y = np.zeros((Ba, T, H, P), F32)
    states = np.zeros((Ba, T // L, H, N, P), F32)
    for (b, c, g, rows, hs), (x, dt, s, B, C, _, _) in _cells(case, arrays):
        sc = _halves(C, B.T.copy(), three)   # once for the group's heads
        for r in range(H // G):
            h = g * (H // G) + r
            e = np.where(tri, _exp(s[:, r, None] - np.where(tri, s[None, :, r], 0)), 0)
            w = np.where(tri, (sc * e).astype(F32) * dt[None, :, r], 0).astype(F32)
            y[b, rows, h] = product(w, x[:, r], three)
            u = (_exp(s[-1, r] - s[:, r]) * dt[:, r]).astype(F32)
            ub = (u[:, None] * B).astype(F32)
            states[b, c, h] = product(ub.T.copy(), x[:, r], three)
    return y, states


def forward_exact(case, arrays):
    """y_diag and the states in float64, no rounding."""
    Ba, T, H, G, N, P, L = case
    tri = np.tril(np.ones((L, L), bool))
    y = np.zeros((Ba, T, H, P))
    states = np.zeros((Ba, T // L, H, N, P))
    for (b, c, g, rows, hs), cell in _cells(case, arrays):
        x, dt, s, B, C, _, _ = (a.astype(F64) for a in cell)
        for r in range(H // G):
            h = g * (H // G) + r
            e = np.where(tri, np.exp(s[:, r, None] - np.where(tri, s[None, :, r], 0)), 0)
            y[b, rows, h] = ((C @ B.T) * e * dt[None, :, r]) @ x[:, r]
            u = np.exp(s[-1, r] - s[:, r]) * dt[:, r]
            states[b, c, h] = (u[:, None] * B).T @ x[:, r]
    return y, states


def backward_model(case, arrays, three=True):
    """The float32 backward: (dx, ddt, ds, dB, dC) as ssd_bwd_dc (dW, M, dC
    with rows t) and ssd_bwd_dxdb (dW^T, P1^T, M^T, dB, W^T, V, dX with rows
    j) compute them."""
    Ba, T, H, G, N, P, L = case
    tri = np.tril(np.ones((L, L), bool))   # [t][j]
    dx = np.zeros((Ba, T, H, P), F32)
    ddt = np.zeros((Ba, T, H), F32)
    ds = np.zeros((Ba, T // L, L, H), F32)
    dB = np.zeros((Ba, T, G, N), F32)
    dC = np.zeros((Ba, T, G, N), F32)
    for (b, c, g, rows, hs), (x, dt, s, B, C, dy, dS) in _cells(case, arrays):
        gt = _halves(B, C.T.copy(), three)   # G^T [j][t], once for the group's heads
        for r in range(H // G):
            h = g * (H // G) + r
            xr, yr, dtr, sr = x[:, r], dy[:, r], dt[:, r], s[:, r]
            e = np.where(tri, _exp(sr[:, None] - np.where(tri, sr[None, :], 0)), 0)   # [t][j]
            # ssd_bwd_dc
            dw = product(yr, xr.T.copy(), three)
            m = np.where(tri, (dw * e).astype(F32) * dtr[None, :], 0).astype(F32)
            dC[b, rows, g] = (dC[b, rows, g] + product(m, B, three)).astype(F32)
            # ssd_bwd_dxdb
            triT, eT = tri.T, e.T                                                        # [j][t]
            dwt = product(xr, yr.T.copy(), three)
            gd = (gt * eT).astype(F32)
            p1 = np.where(triT, dwt * gd, 0).astype(F32)
            mt = np.where(triT, (dwt * eT).astype(F32) * dtr[:, None], 0).astype(F32)
            ee = _exp(sr[-1] - sr)
            u = (ee * dtr).astype(F32)
            acc = (dB[b, rows, g] + product(mt, C, three)).astype(F32)
            ux = (u[:, None] * xr).astype(F32)
            dB[b, rows, g] = (acc + product(ux, dS[r].T.copy(), three)).astype(F32)
            wt = np.where(triT, gd * dtr[:, None], 0).astype(F32)
            v = _halves(B, dS[r], three)
            dx[b, rows, h] = (product(wt, yr, three).astype(F64) + u[:, None].astype(F64) * v
                              ).astype(F32)
            big_r = (xr.astype(F64) * v).sum(1).astype(F32)
            rsum = p1.astype(F64).sum(1).astype(F32)
            ddt[b, rows, h] = (rsum + ee.astype(F64) * big_r).astype(F32)
            ev = (u * big_r).astype(F32)
            row = (p1.astype(F64) * dtr[:, None]).sum(0).astype(F32)
            d = ((row - (dtr * rsum).astype(F32)).astype(F32) - ev).astype(F32)
            d[L - 1] = (d[L - 1] + ev.astype(F64).sum().astype(F32)).astype(F32)
            ds[b, c, :, h] = d
    return dx, ddt, ds, dB, dC


def backward_exact(case, arrays):
    """The five gradients in float64, no rounding, and dB, dC per head
    (the terms each group sums)."""
    Ba, T, H, G, N, P, L = case
    tri = np.tril(np.ones((L, L), bool))
    dx, ddt = np.zeros((Ba, T, H, P)), np.zeros((Ba, T, H))
    ds = np.zeros((Ba, T // L, L, H))
    dBh, dCh = np.zeros((Ba, T, H, N)), np.zeros((Ba, T, H, N))
    for (b, c, g, rows, hs), cell in _cells(case, arrays):
        x, dt, s, B, C, dy, dS = (a.astype(F64) for a in cell)
        for r in range(H // G):
            h = g * (H // G) + r
            xr, yr, dtr, sr = x[:, r], dy[:, r], dt[:, r], s[:, r]
            decay = np.where(tri, np.exp(sr[:, None] - np.where(tri, sr[None, :], 0)), 0)
            gd = (C @ B.T) * decay
            w = gd * dtr[None, :]
            dw = np.where(tri, yr @ xr.T, 0)
            m = dw * decay * dtr[None, :]
            dec_end = np.exp(sr[-1] - sr)
            u = dec_end * dtr
            q = xr @ dS[r].T
            dx[b, rows, h] = w.T @ yr + (B * u[:, None]) @ dS[r]
            dCh[b, rows, h] = m @ B
            dBh[b, rows, h] = m.T @ C + u[:, None] * q
            big_r = (B * q).sum(-1)
            p1 = dw * gd
            ddt[b, rows, h] = p1.sum(0) + dec_end * big_r
            e1 = p1 * dtr[None, :]
            ev = u * big_r
            d = e1.sum(1) - e1.sum(0) - ev
            d[-1] += ev.sum()
            ds[b, c, :, h] = d
    grouped = [a.reshape(Ba, T, G, H // G, N).sum(3) for a in (dBh, dCh)]
    return (dx, ddt, ds, *grouped), (dBh, dCh)


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frobenius(got, want, scale=None):
    """||got - want|| / ||scale|| (scale: want); the difference's norm
    where the scale is 0 (ds at L = 1, where every term cancels)."""
    ref = np.linalg.norm((want if scale is None else scale).ravel())
    diff = np.linalg.norm((got - want).ravel())
    return float(diff / ref) if ref > 0 else float(diff)


def _errors(case, three=True, seed=1):
    arrays = _inputs(case, seed)
    fwd = dict(zip(FWD_NAMES, forward_model(case, arrays, three)))
    fwd_want = dict(zip(FWD_NAMES, forward_exact(case, arrays)))
    bwd = dict(zip(BWD_NAMES, backward_model(case, arrays, three)))
    want, (dBh, dCh) = backward_exact(case, arrays)
    bwd_want = dict(zip(BWD_NAMES, want))
    errs = {n: _normwise(fwd[n], fwd_want[n]) for n in FWD_NAMES}
    for n in BWD_NAMES:
        scale = {"dB": dBh, "dC": dCh}.get(n)
        assert bwd[n].shape == bwd_want[n].shape and np.isfinite(bwd[n]).all(), n
        errs[n] = _frobenius(bwd[n], bwd_want[n], scale)
    return errs


def _ids(cases):
    return ["x".join(map(str, c)) for c in cases]


# ---------------------------------------------------------------------------
# the model against exact float64
# ---------------------------------------------------------------------------

def test_the_helpers_are_the_k6_models():
    """The rounding helpers are K6's (imported, not copied): a TF32 part
    keeps no bit of the 13 it drops, and a tile product of 8 terms in
    3xTF32 lies within a few float32 ulps of the exact one."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(16, 8).astype(F32), rng.randn(8, 8).astype(F32)
    big, small = split(a)
    assert not ((tf32(a).view(np.uint32) | big.view(np.uint32) | small.view(np.uint32))
                & 0x1FFF).any()
    exact = a.astype(F64) @ b.astype(F64)
    assert np.abs(product(a, b) - exact).max() <= 8 * np.finfo(F32).eps * np.abs(exact).max()


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_model_lies_well_inside_the_card_tolerance(case):
    errs = _errors(case)
    assert max(errs.values()) <= MODEL_TOL, errs


def test_ds_cancels_exactly_at_one_row_chunks():
    """At L = 1 the two sums of ds are one product each and cancel, and E
    cancels its own total: ds is 0, as in the plain version."""
    case = CASES[-1]
    assert case[-1] == 1
    _, _, ds, _, _ = backward_model(case, _inputs(case, 2))
    assert not ds.any()


def test_one_tf32_product_misses_the_card_tolerance():
    """With one TF32 product per multiply the outputs and the gradients
    leave 1e-5 of exact float64: three products are needed."""
    worst = {}
    for case in CASES[:2]:
        errs = _errors(case, three=False, seed=3)
        assert min(errs[n] for n in ("y_diag", "states", "dx", "dB")) > CARD_TOL, errs
        worst[case] = max(errs.values())
    assert max(worst.values()) > 10 * CARD_TOL, worst


def test_pad_widths_add_nothing():
    """N 12 and P 4 run in 32-column tiles whose pad columns are zero: the
    model with x, B, C, dy and dS zero-padded to 32 gives the unpadded
    outputs bitwise, and zeros in the pad."""
    case = CASES[3]
    Ba, T, H, G, N, P, L = case
    arrays = _inputs(case, 4)
    x, dt, s, B, C, dy, dS = arrays

    def pad(a, axes):
        return np.pad(a, [(0, 32 - a.shape[i] if i in axes else 0) for i in range(a.ndim)])

    padded = (pad(x, (3,)), dt, s, pad(B, (3,)), pad(C, (3,)), pad(dy, (3,)), pad(dS, (3, 4)))
    wide = (Ba, T, H, G, 32, 32, L)
    y, st = forward_model(case, arrays)
    py, pst = forward_model(wide, padded)
    assert np.array_equal(py[..., :P], y) and not py[..., P:].any()
    assert np.array_equal(pst[..., :N, :P], st) and not pst[..., N:, :].any()
    got, pgot = backward_model(case, arrays), backward_model(wide, padded)
    assert np.array_equal(pgot[0][..., :P], got[0])
    for a, pa in zip(got[1:3], pgot[1:3]):
        assert np.array_equal(pa, a)
    for a, pa in zip(got[3:], pgot[3:]):
        assert np.array_equal(pa[..., :N], a) and not pa[..., N:].any()


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

def _heads(Ba, T, H, G, L, sms=plans.H100_SMS):
    """The C plans' rule, written out: the largest divisor of H / G, at most
    8, that leaves two blocks per SM."""
    R, groups = H // G, Ba * (T // L) * G
    return max([1] + [s for s in range(2, min(R, 8) + 1)
                      if R % s == 0 and groups * (R // s) >= 2 * sms])


@pytest.mark.parametrize("shape", plans._SSD_SHAPES, ids=_ids(plans._SSD_SHAPES))
def test_forward_plans_cover_their_output(shape):
    Ba, T, H, G, L = shape
    tf, wg = (plans.ssd_plan(w, Ba, T, H, G, L) for w in (False, True))
    hs = _heads(Ba, T, H, G, L)
    for plan, name, threads in ((tf, "K7 ssd_chunk_kernel_tf32", 256),
                                (wg, "K7 ssd_chunk_kernel_tc", 128)):
        assert launchgrid.check_plan(plan) == []
        assert plan.kernel == name and plan.block == (threads, 1, 1) and plan.tile == (1, 1, hs)
        assert plan.grid == (Ba * (T // L) * H // hs, 1, 1)
    assert (tf.grid, tf.tile, tf.shape) == (wg.grid, wg.tile, wg.shape)


@pytest.mark.parametrize("shape", plans._SSD_BWD_SHAPES, ids=_ids(plans._SSD_BWD_SHAPES))
def test_backward_plan_is_the_forwards(shape):
    Ba, T, H, G, L = shape
    bwd, fwd = plans.ssd_bwd_plan(Ba, T, H, G, L), plans.ssd_plan(False, Ba, T, H, G, L)
    assert launchgrid.check_plan(bwd) == []
    assert (bwd.grid, bwd.block, bwd.tile, bwd.shape) == (fwd.grid, fwd.block, fwd.tile, fwd.shape)
    assert bwd.tile[2] == _heads(Ba, T, H, G, L)


def test_main_shapes_take_eight_heads_a_block():
    """mamba2-1.3b at 4 x 2048 (L 64, one group of 64 heads): 128 (batch,
    chunk) groups of 8 slices of 8 heads, 1024 blocks; where fewer (batch,
    chunk, group) cells would leave the SMs short of two blocks each, fewer
    heads a block (1 x 1000 at L 50: 20 cells of 16 slices of 4)."""
    plan = plans.ssd_bwd_plan(4, 2048, 64, 1, 64)
    assert plan.grid == (1024, 1, 1) and plan.tile == (1, 1, 8)
    assert plans.ssd_plan(False, 1, 1000, 64, 1, 50).tile == (1, 1, 4)
    assert plans.ssd_plan(False, 2, 64, 8, 2, 8).tile == (1, 1, 1)


def test_forward_records_its_plan_under_a_check_and_launches_nothing():
    Ba, T, H, P, N, G, L = 2, 40, 8, 16, 16, 2, 8
    x, dt, A = torch.zeros(Ba, T, H, P), torch.zeros(Ba, T, H), torch.zeros(H)
    B, C = torch.zeros(Ba, T, G, N), torch.zeros(Ba, T, G, N)
    before = kssd.ssd_intra_chunk_cuda.launches, dict(kssd.ssd_intra_chunk_cuda.by_kernel)
    trace = Trace(device_type="cuda")
    with trace.recording([x, dt, A, B, C]):
        y, states, _ = kssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=L)
    assert trace.launches == [plans.ssd_plan(False, Ba, T, H, G, L)]
    assert y.shape == x.shape and states.shape == (Ba, T // L, H, N, P)
    assert (kssd.ssd_intra_chunk_cuda.launches, kssd.ssd_intra_chunk_cuda.by_kernel) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card(case, dev, seed, offset=0):
    """x, B, C as slices of one projection (the Mamba layer's views), the
    projection starting ``offset`` floats past an aligned address; dt, A,
    s, dy, dS."""
    Ba, T, H, G, N, P, L = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = H * P + 2 * G * N
    buf = torch.randn(Ba * T * w + offset, generator=gen, device=dev)
    zx = buf[offset:].view(Ba, T, w)
    x = zx[..., :H * P].view(Ba, T, H, P)
    B = zx[..., H * P:H * P + G * N].view(Ba, T, G, N)
    C = zx[..., H * P + G * N:].view(Ba, T, G, N)
    dt = torch.nn.functional.softplus(torch.randn(Ba, T, H, generator=gen, device=dev) - 2.0)
    A = -torch.exp(torch.rand(H, generator=gen, device=dev))
    dy = torch.randn(Ba, T, H, P, generator=gen, device=dev)
    dS = torch.randn(Ba, T // L, H, N, P, generator=gen, device=dev)
    return x, dt, A, B, C, ssd_ref.chunk_logdecay(dt, A, L), dy, dS


def _rel(a, b):
    d, w = (float(torch.linalg.vector_norm(t)) for t in (a - b, b))
    return d / w if w > 0 else d


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_float32_runs_on_the_tensor_cores_on_card(cuda_device, case):
    x, dt, A, B, C, s, dy, dS = _card(case, cuda_device, 5)
    n0, t0 = kssd.ssd_intra_chunk_cuda.launches, kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"]
    y, states, _ = kssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=case[-1], s=s)
    grads = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    torch.cuda.synchronize()
    assert (kssd.ssd_intra_chunk_cuda.launches - n0,
            kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"] - t0) == (1, 1)
    wy, wst, _ = ssd_ref.ssd_intra_chunk_ref(x, dt, A, B, C, chunk=case[-1])
    for a, b in ((y, wy), (states, wst)):
        assert float((a - b).abs().max() / b.abs().max()) <= CARD_TOL
    for n, a, b in zip(BWD_NAMES, grads,
                       ssd_ref.ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dS)):
        assert _rel(a, b) <= CARD_TOL, (n, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_float32_views_at_any_alignment_on_card(cuda_device, offset):
    """Projections 4, 8 or 16 bytes past an aligned address (the first two
    read in 4-byte pieces, the third in 16-byte ones) give y_diag, the
    states and the gradients of contiguous inputs, bitwise."""
    case = (2, 100, 4, 2, 16, 8, 50)
    x, dt, A, B, C, s, dy, dS = _card(case, cuda_device, 6, offset)
    assert x.data_ptr() % 16 == 4 * offset % 16
    xc, Bc, Cc = (t.contiguous() for t in (x, B, C))
    got = kssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=50, s=s)
    want = kssd.ssd_intra_chunk_cuda(xc, dt, A, Bc, Cc, chunk=50, s=s)
    grads = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    grads_c = kssd.ssd_backward_cuda(xc, dt, s, Bc, Cc, dy, dS)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_c))
