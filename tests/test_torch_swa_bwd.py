"""K6's backward (``kernels/swa/csrc/swa_bwd.cu``): its launch plans on the
CPU, its contract checks, and on the card (marker ``cuda``) the kernel
against its plain version ``swa_backward_ref``.

Card tolerances (float32): dq, dk, dv within 1e-5 normwise of the plain
version (both sum in float32, in other orders); the float32 forward's
output is the same bits with and without the log-sum-exp output, which
is within 1e-5 of ``logsumexp`` of the plain logits; two backward runs
are bitwise equal (no atomics).  The JAX reference has no backward
kernel: ``tests/test_torch_train.py`` holds the plain version against
``jax.grad`` of the reference's ``swa_ref``.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.analysis import launchgrid  # noqa: E402
from repro_torch.analysis.trace import Trace  # noqa: E402
from repro_torch.kernels import plans  # noqa: E402
from repro_torch.kernels.swa import kernel as kswa  # noqa: E402
from repro_torch.kernels.swa import ops as swa_ops  # noqa: E402
from repro_torch.kernels.swa import swa_backward_ref, swa_ref  # noqa: E402

CASES = [  # B, H, Hkv, T, S, D, window
    (4, 32, 8, 2048, 2048, 64, 2048),     # llama3.2-1b's training shape
    (2, 8, 4, 1500, 1500, 256, 1024),     # gemma3's window layers, ragged T
    (8, 6, 2, 128, 128, 64, 128),         # examples/torch_train_lm.py, quick
    (8, 12, 4, 256, 256, 64, 256),        # examples/torch_train_lm.py --full
    (2, 8, 2, 13, 13, 8, 13),             # llama SMOKE width, ragged T
    (1, 4, 1, 50, 77, 128, 20),           # T < S, a window below T
    (3, 6, 3, 70, 70, 192, 33),           # D 192 (three float4 column chunks)
]
TOL = 1e-5


@pytest.mark.parametrize("shape", plans._SWA_BWD_SHAPES + ((1, 4, 1, 50, 77, 128),))
def test_backward_plans_cover_their_outputs(shape):
    B, H, Hkv, T, S, D = shape
    drow, dkdv, dq = plans.swa_bwd_plans(*shape)
    for plan in (drow, dkdv, dq):
        assert launchgrid.check_plan(plan) == [], plan.kernel
    # the tensor-core kernels: four warps a block, 64 keys and 128 q rows (64 above D 64)
    bm = 128 if D <= 64 else 64
    assert dkdv.block == dq.block == (128, 1, 1)
    assert dkdv.tile == (1, 1, 64) and dq.tile == (1, 1, bm)
    assert dkdv.grid == (B * Hkv, -(-S // 64), 1) and dq.grid == (B * H, -(-T // bm), 1)


def test_backward_records_its_plans_under_a_check_and_launches_nothing():
    """Under an analyzer check K6's forward with its LSE and the backward
    record their plans; nothing is launched."""
    B, H, Hkv, T, S, D = 2, 8, 2, 40, 40, 16
    q, o, do = (torch.zeros(B, H, T, D) for _ in range(3))
    k, v = torch.zeros(B, Hkv, S, D), torch.zeros(B, Hkv, S, D)
    lse = torch.zeros(B, H, T)
    before = kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches
    trace = Trace(device_type="cuda")
    with trace.recording([q, k, v, o, do, lse]):
        o2, lse2 = kswa.swa_attention_cuda(q, k, v, window=16, return_lse=True)
        dq, dk, dv = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=16)
    assert [p.kernel for p in trace.launches] == ["K6 swa_kernel_tf32", "K6b swa_bwd_drow",
                                                  "K6b swa_bwd_dkdv", "K6b swa_bwd_dq"]
    assert trace.launches[0] == plans.swa_plan(False, B, H, T, D)
    assert trace.launches[1:] == list(plans.swa_bwd_plans(B, H, Hkv, T, S, D))
    assert (o2.shape, lse2.shape) == (q.shape, lse.shape)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert (kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches) == before


def test_backward_wrapper_refuses_cpu_tensors_and_bfloat16():
    q = torch.zeros(1, 2, 8, 8)
    k = torch.zeros(1, 1, 8, 8)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        kswa.swa_backward_cuda(q, k, k, q, q, lse, window=8)
    with pytest.raises(ValueError, match="float32"):
        kswa.swa_attention_cuda(q.bfloat16(), k.bfloat16(), k.bfloat16(), window=8,
                                return_lse=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(case, dev, seed=0):
    B, H, Hkv, T, S, D, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    # the model's layout: (B, T, H, D) buffers seen as (B, H, T, D)
    q = torch.randn(B, T, H, D, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).transpose(1, 2)
    do = torch.randn(B, T, H * D, generator=g, device=dev).view(B, T, H, D).transpose(1, 2)
    return q, k, v, do


def _normwise(got, want):
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_kernel_vs_plain_on_card(cuda_device, case):
    q, k, v, do = _inputs(case, cuda_device)
    w = case[-1]
    o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
    n0 = kswa.swa_backward_cuda.launches
    got = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
    again = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
    torch.cuda.synchronize()
    assert kswa.swa_backward_cuda.launches == n0 + 2
    want = swa_backward_ref(q, k, v, do, window=w)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _normwise(a, b) <= TOL, (name, _normwise(a, b))
        assert torch.equal(a, c), name   # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[1:], ids=lambda c: "x".join(map(str, c)))
def test_forward_lse_output_leaves_o_bitwise_on_card(cuda_device, case):
    q, k, v, _ = _inputs(case, cuda_device, seed=1)
    w = case[-1]
    o0 = kswa.swa_attention_cuda(q, k, v, window=w)
    o1, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o0, o1)
    B, H, T, D = q.shape
    S = k.shape[2]
    kr = torch.repeat_interleave(k, H // k.shape[1], 1)
    logits = torch.einsum("bhtd,bhsd->bhts", q * D ** -0.5, kr)
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)
    want = torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1)
    assert (lse - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.cuda
def test_autograd_route_on_card(cuda_device):
    case = (2, 8, 2, 300, 300, 64, 100)
    q, k, v, do = _inputs(case, cuda_device, seed=2)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    f0, b0 = kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches
    got = torch.autograd.grad(swa_ops.swa_attention(q, k, v, window=100), (q, k, v), do)
    assert (kswa.swa_attention_cuda.launches - f0, kswa.swa_backward_cuda.launches - b0) == (1, 1)
    want = torch.autograd.grad(swa_ref(q, k, v, window=100), (q, k, v), do)
    for a, b in zip(got, want):
        assert _normwise(a, b) <= TOL
    with pytest.raises(NotImplementedError, match="float32"):
        swa_ops.swa_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=100)
