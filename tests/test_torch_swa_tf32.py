"""Why K6's float32 kernels take three TF32 products (3xTF32), and their
launch plans.

K6's float32 forward (``kernels/swa/csrc/swa.cu``, ``swa_kernel_tf32``) and
its backward (``kernels/swa/csrc/swa_bwd.cu``) run every product on the
tensor cores in TF32, which keeps 10 mantissa bits.  A float64 NumPy model
rounds where the kernels round:

* TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero,
  the 13 low bits dropped;
* each float32 operand split into big = rna(x) and small = rna(x - big),
  a product taken as a_small b_big + a_big b_small + a_big b_big;
* each tile's product (S and dP of a tile, and the P V, P^T dO, dS^T Q and
  dS K of one tile) summed on the tensor cores from a zero accumulator,
  which cuts each sum of 8 products toward zero in float32;
* float32 rounded to nearest wherever the CUDA cores work: the sums of the
  tiles' products in the kernels' order (O = O alpha + P V as one fmaf),
  the online softmax's m, l and rescaling, the logits scaled into log2
  units, the LSE, Drow.

At small cases of ``tests/test_torch_swa.py`` and of
``tests/test_torch_swa_bwd.py::CASES`` cut in T (head widths 8 to 256), the
model lies within 2e-6 of exact float64 attention and its gradients for D
up to 128, and within 5e-6 above (its products over D sum 3 D / 8 steps in
one truncating accumulator), inside the card's 1e-5 (``chip_smoke.K6_TOL``,
``K6B_TOL``): normwise for the output and the LSE, in relative Frobenius
norm for dq, dk and dv, as the card's checks measure them.  The same model with one TF32 product per
multiply exceeds 1e-5: one product cannot meet the tolerances.

On the card (marker ``cuda``): a float32 call counts as a tensor-core
launch, forward and backward within 1e-5 of their plain versions; views
at any alignment give the results of contiguous inputs bitwise.
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
from repro_torch.kernels.swa import kernel as kswa  # noqa: E402
from repro_torch.kernels.swa import swa_backward_ref, swa_ref  # noqa: E402

F32, F64 = np.float32, np.float64
LOG2E = F32(1.4426950408889634)
LN2 = F32(0.6931471805599453)
# the 3xTF32 model against exact float64: the products over D sum 3 D / 8
# steps in one truncating accumulator, so wider heads drift further
MODEL_TOL = {128: 2e-6, 256: 5e-6}   # D up to 128, D up to 256
CARD_TOL = 1e-5     # chip_smoke.K6_TOL["float32"] and K6B_TOL

# B, H, Hkv, T, S, D, window: tests/test_torch_swa.py's cases (the reference
# tests' windows, GQA, queries offset into a longer kv sequence, gemma3's
# head width 256, a ragged T of S), and D 8 and D 192
FWD_CASES = [(2, 4, 2, 64, 64, 32, 4), (2, 4, 2, 64, 64, 32, 10_000), (1, 8, 2, 32, 32, 16, 16),
             (1, 4, 4, 16, 128, 32, 48), (1, 2, 1, 64, 64, 64, 32), (1, 8, 4, 50, 50, 256, 1024),
             (1, 2, 1, 5, 77, 64, 3), (2, 8, 2, 13, 13, 8, 13), (3, 6, 3, 70, 70, 192, 33)]
# tests/test_torch_swa_bwd.py::CASES cut in T (gemma3's window cut with it,
# so that it stays below T)
BWD_CASES = [(4, 32, 8, 64, 64, 64, 64), (2, 8, 4, 64, 64, 256, 40), (8, 6, 2, 96, 96, 64, 96),
             (8, 12, 4, 64, 64, 64, 64), (2, 8, 2, 13, 13, 8, 13), (1, 4, 1, 50, 77, 128, 20),
             (3, 6, 3, 70, 70, 192, 33)]


def tf32(x):
    """float32 rounded as cvt.rna.tf32.f32 rounds it (to nearest, ties away
    from zero, 13 low bits dropped), kept in float32."""
    b = np.ascontiguousarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def split(x):
    """big, small: the two TF32 parts of float32 x (x - big is exact)."""
    x = np.asarray(x, F32)
    big = tf32(x)
    return big, tf32(x - big)


def _toward_zero(x):
    """float64 cut to float32 toward zero: rounded to nearest, then one ulp
    back toward zero where that went past x (one less in the bits)."""
    y = x.astype(F32)
    y.view(np.int32)[...] -= np.abs(y) > np.abs(x)
    return y


def product(a, b, three=True):
    """a @ b, (..., M, K) by (..., K, N) float32 operands, as the tensor
    cores take one tile's product from a zero accumulator: per step of 8
    terms (one m16n8k8) the 8 products exact and their sum added to the
    accumulator, cut to float32 toward zero; in 3xTF32 three steps per 8
    terms (small-big, big-small, big-big), else one TF32 product."""
    K = a.shape[-1]
    pad = -K % 8
    a = np.pad(a, ((0, 0),) * (a.ndim - 1) + ((0, pad),))
    b = np.pad(b, ((0, 0),) * (b.ndim - 2) + ((0, pad), (0, 0)))
    if three:
        (ab, as_), (bb, bs) = split(a), split(b)
        terms = ((as_, bb), (ab, bs), (ab, bb))
    else:
        terms = ((tf32(a), tf32(b)),)
    G = a.shape[-1] // 8
    steps = [np.matmul(x.astype(F64).reshape(*x.shape[:-1], G, 8).swapaxes(-2, -3),
                       y.astype(F64).reshape(*y.shape[:-2], G, 8, y.shape[-1]))
             for x, y in terms]   # (..., G, M, N): the products of each step of 8
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], F32)
    for gi in range(G):
        for st in steps:
            acc = _toward_zero(acc.astype(F64) + st[..., gi, :, :])
    return acc


def _mask(T, S, window):
    qpos, kpos = np.arange(T)[:, None] + (S - T), np.arange(S)[None, :]
    return (kpos <= qpos) & (kpos > qpos - min(window, S))


def forward_model(q, k, v, window, three=True, scale=None):
    """The float32 forward: per kv tile of BN keys (32 at D up to 64 and
    above 128, else 64) the logits in log2 units, the online softmax in
    float32, O = O alpha + P V; O / l and the LSE (natural units) at the
    end."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    bn = 64 if 64 < D <= 128 else 32
    kr, vr = (np.repeat(a, H // Hkv, axis=1) for a in (k, v))
    c = F32(F32(D ** -0.5 if scale is None else scale) * LOG2E)
    ok_all = _mask(T, S, window)
    m = np.full((B, H, T), -1e30, F32)
    l = np.zeros((B, H, T), F32)
    acc = np.zeros((B, H, T, D), F32)
    for j0 in range(0, S, bn):
        kt, vt, ok = kr[:, :, j0:j0 + bn], vr[:, :, j0:j0 + bn], ok_all[:, j0:j0 + bn]
        s = np.where(ok, product(q, kt.swapaxes(-1, -2), three) * c, F32(-1e30))
        mx = np.maximum(m, s.max(-1))
        alpha = np.exp2((m - mx).astype(F64)).astype(F32)
        p = np.where(ok, np.exp2((s - mx[..., None]).astype(F64)), 0.0).astype(F32)
        l = (alpha * l + p.sum(-1, dtype=F32)).astype(F32)
        acc = (acc.astype(F64) * alpha[..., None] + product(p, vt, three)).astype(F32)
        m = mx
    o = acc / np.where(l == 0, F32(1), l)[..., None]
    lse = (m * LN2 + np.log(l.astype(F64)).astype(F32)).astype(F32)
    return o.astype(F32), lse


def backward_model(q, k, v, do, window, three=True):
    """The backward: P from the forward's LSE in log2 units, dP, dS in
    float32; dQ summed over kv tiles of BN keys (as the forward's), dK and dV
    over the group's heads and their q tiles of BQ rows (64 at D up to 64,
    else 32), in float32."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    grp = H // Hkv
    bn, bq = (64 if 64 < D <= 128 else 32), (64 if D <= 64 else 32)
    o, lse = forward_model(q, k, v, window, three)
    kr, vr = (np.repeat(a, grp, axis=1) for a in (k, v))
    c, scale = F32(F32(D ** -0.5) * LOG2E), F32(D ** -0.5)
    L = (lse * LOG2E).astype(F32)
    drow = (do.astype(F64) * o.astype(F64)).sum(-1).astype(F32)
    ok = _mask(T, S, window)
    s = product(q, kr.swapaxes(-1, -2), three)
    p = np.where(ok, np.exp2((s * c - L[..., None]).astype(F64)), 0.0).astype(F32)
    dp = product(do, vr.swapaxes(-1, -2), three)
    ds = (p * (dp - drow[..., None])).astype(F32)
    dq = np.zeros((B, H, T, D), F32)
    for j0 in range(0, S, bn):
        dq = (dq + product(ds[..., j0:j0 + bn], kr[:, :, j0:j0 + bn], three)).astype(F32)
    dk = np.zeros((B, Hkv, S, D), F32)
    dv = np.zeros((B, Hkv, S, D), F32)
    pg, dsg = p.reshape(B, Hkv, grp, T, S), ds.reshape(B, Hkv, grp, T, S)
    qg, dog = q.reshape(B, Hkv, grp, T, D), do.reshape(B, Hkv, grp, T, D)
    for hh in range(grp):
        for i0 in range(0, T, bq):
            rows = slice(i0, i0 + bq)
            dv = (dv + product(pg[:, :, hh, rows].swapaxes(-1, -2), dog[:, :, hh, rows],
                               three)).astype(F32)
            dk = (dk + product(dsg[:, :, hh, rows].swapaxes(-1, -2), qg[:, :, hh, rows],
                               three)).astype(F32)
    return (dq * scale).astype(F32), (dk * scale).astype(F32), dv, lse


def exact(q, k, v, do, window):
    """Attention, its LSE and its gradients in float64, no rounding."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    grp = H // Hkv
    q, k, v, do = (a.astype(F64) for a in (q, k, v, do))
    kr, vr = (np.repeat(a, grp, axis=1) for a in (k, v))
    s = np.where(_mask(T, S, window), q @ kr.swapaxes(-1, -2) * D ** -0.5, -np.inf)
    mx = s.max(-1, keepdims=True)
    e = np.exp(s - mx)
    lse = mx[..., 0] + np.log(e.sum(-1))
    p = e / e.sum(-1, keepdims=True)
    o = p @ vr
    dp = do @ vr.swapaxes(-1, -2)
    ds = p * (dp - (do * o).sum(-1, keepdims=True))
    dq = ds @ kr * D ** -0.5
    dk = (ds.swapaxes(-1, -2) @ q * D ** -0.5).reshape(B, Hkv, grp, S, D).sum(2)
    dv = (p.swapaxes(-1, -2) @ do).reshape(B, Hkv, grp, S, D).sum(2)
    return o, lse, dq, dk, dv


def _inputs(case, seed):
    B, H, Hkv, T, S, D, _ = case
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(F32) for shape in
                 ((B, H, T, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, T, D)))


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frobenius(got, want):
    return float(np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()), 1e-30))


def _ids(cases):
    return ["x".join(map(str, c)) for c in cases]


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------

def test_tf32_rounds_to_nearest_ties_away_dropping_13_bits():
    one = 0x3F800000
    bits = np.array([one, one + 0x0FFF, one + 0x1000, one + 0x1FFF, one + 0x3000, 0x3FFFF000,
                     one | 0x80000000 | 0x1000, 0x00001000, 0x7F7FF000], np.uint32)
    got = tf32(bits.view(F32)).view(np.uint32)
    want = np.array([one, one, one + 0x2000, one + 0x2000, one + 0x4000, 0x40000000,
                     (one | 0x80000000) + 0x2000, 0x00002000, 0x7F800000], np.uint32)
    assert got.tolist() == want.tolist()
    assert not (got & 0x1FFF).any()


def test_split_leaves_out_about_2_to_the_minus_21():
    x = np.random.RandomState(0).randn(100_000).astype(F32) * F32(3.0)
    big, small = split(x)
    assert not ((big.view(np.uint32) | small.view(np.uint32)) & 0x1FFF).any()
    rest = np.abs(x.astype(F64) - big - small) / np.abs(x.astype(F64))
    assert rest.max() <= 2.0 ** -21
    # one TF32 part alone leaves up to 2^-11
    assert (np.abs(x.astype(F64) - big) / np.abs(x.astype(F64))).max() > 2.0 ** -13


# ---------------------------------------------------------------------------
# the model against exact attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FWD_CASES, ids=_ids(FWD_CASES))
def test_forward_model_lies_well_inside_the_card_tolerance(case):
    q, k, v, _ = _inputs(case, 1)
    w = case[-1]
    o, lse = forward_model(q, k, v, w)
    eo, exact_lse, *_ = exact(q, k, v, q, w)
    assert o.shape == q.shape and np.isfinite(o).all() and np.isfinite(lse).all()
    tol = MODEL_TOL[128 if case[5] <= 128 else 256]
    assert _normwise(o, eo) <= tol
    assert _normwise(lse, exact_lse) <= tol


@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
def test_backward_model_lies_well_inside_the_card_tolerance(case):
    q, k, v, do = _inputs(case, 2)
    w = case[-1]
    got = backward_model(q, k, v, do, w)
    want = exact(q, k, v, do, w)
    tol = MODEL_TOL[128 if case[5] <= 128 else 256]
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[2:]):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        assert _frobenius(a, b) <= tol, (name, _frobenius(a, b))
    assert _normwise(got[3], want[1]) <= tol


def test_one_tf32_product_misses_the_card_tolerance():
    """With one TF32 product per multiply the output and the gradients
    leave 1e-5 of exact attention: three products are needed."""
    worst = {}
    for case in (FWD_CASES[4], BWD_CASES[5]):
        q, k, v, do = _inputs(case, 3)
        w = case[-1]
        dq, dk, dv, _ = backward_model(q, k, v, do, w, three=False)
        o, _ = forward_model(q, k, v, w, three=False)
        eo, _, edq, edk, edv = exact(q, k, v, do, w)
        worst[case] = max(_normwise(o, eo), _frobenius(dq, edq), _frobenius(dk, edk),
                          _frobenius(dv, edv))
    assert max(worst.values()) > CARD_TOL, worst


@pytest.mark.parametrize("D", [8, 192])
def test_pad_widths_add_nothing(D):
    """D 8 runs in a 64-column tile, D 192 in a 256-column one, the pad
    columns zero: the model with the inputs zero-padded to the tile's width
    (and D's scale) equals the unpadded one bitwise."""
    case = next(c for c in FWD_CASES if c[5] == D)
    q, k, v, _ = _inputs(case, 4)
    dp = 64 if D <= 64 else 256
    pad = lambda a: np.pad(a, ((0, 0),) * 3 + ((0, dp - D),))  # noqa: E731
    o, lse = forward_model(q, k, v, case[-1])
    po, plse = forward_model(pad(q), pad(k), pad(v), case[-1], scale=D ** -0.5)
    assert np.array_equal(po[..., :D], o) and np.array_equal(plse, lse)
    assert not po[..., D:].any()


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", plans._SWA_SHAPES, ids=_ids(plans._SWA_SHAPES))
def test_float32_forward_plan_covers_its_output(shape):
    B, H, T, D = shape
    plan = plans.swa_plan(False, B, H, T, D)
    assert launchgrid.check_plan(plan) == []
    bm = 128 if D <= 64 else 64   # q rows a block: two m-tiles a warp at D up to 64
    assert plan.kernel == "K6 swa_kernel_tf32" and plan.block == (128, 1, 1)
    assert plan.grid == (B * H, -(-T // bm), 1) and plan.tile == (1, 1, bm)


def test_forward_records_its_plan_under_a_check_and_launches_nothing():
    B, H, Hkv, T, S, D = 2, 8, 2, 70, 70, 64
    q = torch.zeros(B, H, T, D)
    k, v = torch.zeros(B, Hkv, S, D), torch.zeros(B, Hkv, S, D)
    before = kswa.swa_attention_cuda.launches, kswa.swa_attention_cuda.tc_launches
    trace = Trace(device_type="cuda")
    with trace.recording([q, k, v]):
        o = kswa.swa_attention_cuda(q, k, v, window=16)
    assert trace.launches == [plans.swa_plan(False, B, H, T, D)]
    assert o.shape == q.shape
    assert (kswa.swa_attention_cuda.launches, kswa.swa_attention_cuda.tc_launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_float32_runs_on_the_tensor_cores_on_card(cuda_device):
    B, H, Hkv, T, S, D, w = 2, 8, 2, 300, 300, 64, 100
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn(B, T, H, D, generator=g, device=cuda_device).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).transpose(1, 2)
    do = torch.randn(B, T, H, D, generator=g, device=cuda_device).transpose(1, 2)
    n0, tc0 = kswa.swa_attention_cuda.launches, kswa.swa_attention_cuda.tc_launches
    o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
    grads = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
    torch.cuda.synchronize()
    assert (kswa.swa_attention_cuda.launches - n0, kswa.swa_attention_cuda.tc_launches - tc0) \
        == (1, 1)
    want = swa_ref(q, k, v, window=w)
    assert float((o - want).abs().max() / want.abs().max()) <= CARD_TOL
    for a, b in zip(grads, swa_backward_ref(q, k, v, do, window=w)):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_float32_views_at_any_alignment_on_card(cuda_device, offset):
    """float32 views 4, 8 or 16 bytes past an aligned address (the first two
    read in 4-byte pieces, the third in 16-byte ones) give the output, the
    LSE and the gradients of contiguous inputs, bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    B, H, Hkv, T, S, D, w = 1, 4, 2, 40, 70, 32, 24

    def view(heads, n):
        buf = torch.randn(B * n * heads * D + offset, generator=g, device=cuda_device)
        return buf[offset:].view(B, n, heads, D).transpose(1, 2)

    q, k, v, do = view(H, T), view(Hkv, S), view(Hkv, S), view(H, T)
    assert q.data_ptr() % 16 == 4 * offset % 16
    o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    oc, lse_c = kswa.swa_attention_cuda(qc, kc, vc, window=w, return_lse=True)
    grads = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
    grads_c = kswa.swa_backward_cuda(qc, kc, vc, oc, doc, lse_c, window=w)
    torch.cuda.synchronize()
    assert torch.equal(o, oc) and torch.equal(lse, lse_c)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_c))
