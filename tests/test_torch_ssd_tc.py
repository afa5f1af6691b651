"""K7's tensor-core kernel (``ssd_chunk_kernel_tc`` in
``src/repro_torch/kernels/ssd/csrc/ssd.cu``) on the CPU: its numeric plan and
the wrapper's rules.

* ``tc_plan`` is a plain torch model of the kernel's arithmetic: C B^T once
  per group in float32, W selected on the causal mask and split into two
  bf16 terms, Y = W_hi X + W_lo X, u X (u_j = exp(s_{L-1} - s_j) dt_j)
  split into three bf16 terms, S_c = B^T (t0 + t1 + t2) (the kernel forms
  its transpose, (t0 + t1 + t2)^T B), every sum float32.
  It is held against the plain version ``ssd_intra_chunk_ref`` at K7's
  tolerances (``chip_smoke.K7_TOL``, normwise max |plan - plain| / max
  |plain|): y_diag 1e-2 (one bf16 rounding of a float32 result), states
  1e-5, at L 64 and the ragged L 50, G 1 and 2, with inputs made as
  ``chip_smoke.k7_inputs`` makes them (softplus dt, A = -exp(U(0, 1))).
  With u X rounded once, the states miss 1e-5 by far: the reason for three
  terms.
* ``kernel_for`` (the C entry point's rule: bf16 at N and P multiples of
  8 on wgmma, the rest in 3xTF32), ``check_args`` (what neither kernel
  takes) and ``kernels.tma_ready`` (which views are copied before
  a tensor-core launch) as plain functions.

The ``cuda``-marked tests of ``tests/test_torch_ssd.py`` hold the kernel
itself against its plain version on the card.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.kernels import tma_ready  # noqa: E402
from repro_torch.kernels.ssd import kernel as K  # noqa: E402
from repro_torch.kernels.ssd.ref import chunk_logdecay, ssd_intra_chunk_ref  # noqa: E402

TOL = {"y_diag": 1e-2, "states": 1e-5}   # K7_TOL["bfloat16"] of chip_smoke.py
LOG2E = 1.4426950408889634


def _terms(v, n: int):
    """v (float32) as the sum of n bf16 terms, each the rounding of what the
    terms before it left; returned as float32."""
    out = []
    for _ in range(n):
        t = v.bfloat16().float()
        out.append(t)
        v = v - t
    return out


def tc_plan(x, dt, A, B, C, *, chunk: int, ux_terms: int = 3, w_terms: int = 2):
    """The tensor-core kernel's arithmetic in plain torch: (y_diag in x's
    dtype, states float32)."""
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    L, nc, R = chunk, T // chunk, H // G
    s = chunk_logdecay(dt, A, L).permute(0, 1, 3, 2)            # (Ba, nc, H, L)
    dtc = dt.float().reshape(Ba, nc, L, H).permute(0, 1, 3, 2)  # (Ba, nc, H, L)
    xh = x.float().reshape(Ba, nc, L, H, P).permute(0, 1, 3, 2, 4)  # (Ba, nc, H, L, P)
    Bg = B.float().reshape(Ba, nc, L, G, N).permute(0, 1, 3, 2, 4)  # (Ba, nc, G, L, N)
    Cg = C.float().reshape(Ba, nc, L, G, N).permute(0, 1, 3, 2, 4)
    scores = (Cg @ Bg.transpose(-1, -2)).repeat_interleave(R, dim=2)  # once per group
    decay = torch.exp2((s[..., :, None] - s[..., None, :]) * LOG2E)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    w = torch.where(tri, scores * decay * dtc[..., None, :], torch.zeros(()))
    y = sum(t @ xh for t in _terms(w, w_terms))
    u = torch.exp(s[..., L - 1:] - s) * dtc
    Bh = Bg.repeat_interleave(R, dim=2).transpose(-1, -2)      # (Ba, nc, H, N, L)
    states = sum(Bh @ t for t in _terms(u[..., None] * xh, ux_terms))
    return y.permute(0, 1, 3, 2, 4).reshape(Ba, T, H, P).to(x.dtype), states


def _inputs(seed, Ba, T, H, P, N, G):
    """bf16 x, B, C from a numpy seed, softplus dt, A = -exp(U(0, 1))."""
    rng = np.random.RandomState(seed)

    def bf(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()

    x, B, C = bf((Ba, T, H, P)), bf((Ba, T, G, N)), bf((Ba, T, G, N))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.randn(Ba, T, H).astype(np.float32)) - 2.0)
    A = -torch.exp(torch.from_numpy(rng.rand(H).astype(np.float32)))
    return x, dt, A, B, C


def _normwise(got, want) -> float:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d / scale if scale > 0 else d


PLAN_CASES = [(L, G) for L in (64, 50) for G in (1, 2)]


@pytest.mark.parametrize("L,G", PLAN_CASES, ids=[f"L{L}-G{G}" for L, G in PLAN_CASES])
def test_tc_plan_vs_plain(L, G):
    ins = _inputs(L + G, 2, 2 * L, 4, 64, 128, G)
    y, st = tc_plan(*ins, chunk=L)
    y0, st0, _ = ssd_intra_chunk_ref(*ins, chunk=L)
    assert y.dtype == y0.dtype == torch.bfloat16 and y.shape == y0.shape
    assert st.shape == st0.shape
    e_y, e_st = _normwise(y, y0), _normwise(st, st0)
    assert math.isfinite(e_y) and e_y <= TOL["y_diag"], e_y
    assert math.isfinite(e_st) and e_st <= TOL["states"], e_st


def test_tc_plan_needs_three_terms_of_ux():
    """Rounded once to bf16, u X puts the states ~2e-3 off, some 200 times
    K7's tolerance; three terms hold them to it."""
    ins = _inputs(7, 2, 128, 4, 64, 128, 1)
    _, st0, _ = ssd_intra_chunk_ref(*ins, chunk=64)
    errs = [_normwise(tc_plan(*ins, chunk=64, ux_terms=n)[1], st0) for n in (1, 3)]
    assert errs[0] > 100 * TOL["states"] and errs[1] <= TOL["states"], errs


@pytest.mark.parametrize("ragged_rows", [False, True])
def test_tc_plan_per_group_scores_equal_per_head(ragged_rows):
    """C B^T computed once per group gives what the per-head form gives:
    B/C repeated per head (G = H) through the same plan."""
    L = 50 if ragged_rows else 64
    x, dt, A, B, C = _inputs(11, 1, 2 * L, 4, 64, 128, 2)
    y_g, st_g = tc_plan(x, dt, A, B, C, chunk=L)
    y_h, st_h = tc_plan(x, dt, A, B.repeat_interleave(2, 2), C.repeat_interleave(2, 2), chunk=L)
    assert torch.equal(y_g, y_h) and torch.equal(st_g, st_h)


def test_kernel_rule():
    wg, tf = K.KERNELS[1], K.KERNELS[0]
    assert (tf, wg) == ("3xTF32", "wgmma")   # both on the tensor cores
    bf, f32 = torch.bfloat16, torch.float32
    assert [K.kernel_for(bf, n, p) for n, p in ((128, 64), (16, 16), (16, 8), (8, 8))] == [wg] * 4
    assert [K.kernel_for(bf, n, p) for n, p in ((8, 4), (12, 8), (128, 60))] == [tf] * 3
    assert [K.kernel_for(f32, n, p) for n, p in ((128, 64), (16, 8), (8, 4))] == [tf] * 3


def _mk(T=16, H=2, G=1, N=16, P=8, dtype=torch.float32):
    return (torch.zeros(1, T, H, P, dtype=dtype), torch.zeros(1, T, H), torch.zeros(H),
            torch.zeros(1, T, G, N, dtype=dtype), torch.zeros(1, T, G, N, dtype=dtype))


@pytest.mark.parametrize("args,chunk,match", [
    (_mk(T=128), 128, "chunk"), (_mk(), 5, "chunk"), (_mk(), 0, "chunk"),
    (_mk(N=256), 8, "N <="), (_mk(P=6), 8, "P"), (_mk(P=72), 8, "P <="),
    (_mk(dtype=torch.float64), 8, "dtype"), (_mk(G=3, H=4), 8, "shapes"),
], ids=["L128", "L-not-divisor", "L0", "N256", "P6", "P72", "f64", "G-not-divisor"])
def test_check_args_raises(args, chunk, match):
    with pytest.raises(ValueError, match=match):
        K.check_args(*args, chunk=chunk)


def test_check_args_takes_the_kernels_shapes():
    for kw, chunk in ((dict(), 8), (dict(N=128, P=64, T=128), 64), (dict(P=4, N=8), 1),
                      (dict(G=2, H=4, dtype=torch.bfloat16), 16)):
        K.check_args(*_mk(**kw), chunk=chunk)
    x, dt, A, B, C = _mk()
    with pytest.raises(ValueError, match="contiguous"):
        K.check_args(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C, chunk=8)


def test_tma_ready_views():
    """The Mamba layer's slices of one projection launch without a copy; a
    projection whose row is not a multiple of 8 elements is copied."""
    Ba, T, H, P, G, N = 2, 32, 4, 64, 1, 128
    for extra, ready in ((0, True), (3, False)):
        zx = torch.zeros(Ba, T, H * P + 2 * G * N + extra, dtype=torch.bfloat16)
        views = (zx[..., :H * P].view(Ba, T, H, P),
                 zx[..., H * P:H * P + G * N].view(Ba, T, G, N),
                 zx[..., H * P + G * N:H * P + 2 * G * N].view(Ba, T, G, N))
        assert [tma_ready(v) for v in views] == [ready] * 3
        copies = [v.clone(memory_format=torch.contiguous_format) for v in views]
        assert all(tma_ready(c) and torch.equal(c, v) for c, v in zip(copies, views))
