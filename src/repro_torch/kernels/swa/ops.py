"""Public sliding-window attention ops: K6 on a CUDA tensor, the plain
version on a CPU tensor.

``use_kernel``: ``"auto" | "cuda" | "ref"`` through
:mod:`repro_torch.kernels.dispatch`.  :func:`swa_attention` is K6's one
dispatch point; the model's attention calls it for every causal
self-attention in train and prefill, at any T.  On a CUDA tensor the
dtype alone then picks K6's kernel, both on the tensor cores: bfloat16 on
``wgmma``, float32 in 3xTF32.  Where grad mode is on and q, k or v requires
grad (training), the CUDA route is a ``torch.autograd.Function``: K6's
float32 forward, which also writes the rows' log-sum-exp, and K6's
backward kernel (``swa_backward_cuda``); bfloat16 raises there (the
backward kernel is float32).  A CPU tensor keeps ``swa_ref`` and plain
autograd.
:func:`sliding_window_attention` is the JAX package's op: the same
function under the reference op's contract, which raises where its
Pallas kernel's tiles do not divide T and S.
"""

from __future__ import annotations

import torch

from .. import dispatch
from .kernel import swa_attention_cuda, swa_backward_cuda
from .ref import swa_lse_ref, swa_ref


class _SwaCuda(torch.autograd.Function):
    """K6 forward and K6 backward, float32 (saves q, k, v, o and the LSE)."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        o, lse = swa_attention_cuda(q, k, v, window=window, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = swa_backward_cuda(q, k, v, o, do, lse, window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None


def swa_attention(q, k, v, *, window: int, scale: float | None = None,
                  use_kernel: str = "auto", return_lse: bool = False):
    """Causal sliding-window GQA attention, q (B, H, T, D), k/v
    (B, Hkv, S, D), the queries the last T of S; see ``ref.swa_ref``.
    ``return_lse``: also return each row's log-sum-exp, (B, H, T) float32
    (K6's float32 kernel only; ``ref.swa_lse_ref`` on the plain path); the
    kernel route then takes no gradient."""
    if dispatch.resolve(use_kernel, q, where="swa.swa_attention") == "ref":
        if return_lse:
            return swa_lse_ref(q, k, v, window=window, scale=scale)
        return swa_ref(q, k, v, window=window, scale=scale)
    if return_lse:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise NotImplementedError(
                "swa.swa_attention: K6's backward takes no gradient of the log-sum-exp "
                "(use_kernel='ref' differentiates the plain version)")
        return swa_attention_cuda(q, k, v, window=window, scale=scale, return_lse=True)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.dtype != torch.float32:
            raise NotImplementedError(
                f"swa.swa_attention: K6's backward kernel takes float32, got {q.dtype} with "
                "gradients required (train in float32, or use_kernel='ref')")
        return _SwaCuda.apply(q, k, v, window, scale)
    return swa_attention_cuda(q, k, v, window=window, scale=scale)


def sliding_window_attention(q, k, v, *, window: int, scale: float | None = None,
                             use_kernel: str = "auto", bq: int = 128, bk: int = 128):
    """The reference op: raises ``ValueError`` where ``T % min(bq, T)`` or
    ``S % min(bk, S)`` is not 0, as ``swa_pallas`` does; otherwise
    :func:`swa_attention` (K6 takes its own tiles, so ``bq``/``bk`` only
    set that contract)."""
    T, S = q.shape[2], k.shape[2]
    bq, bk = min(bq, T), min(bk, S)
    if T % bq or S % bk:
        raise ValueError(f"T={T} % bq={bq} or S={S} % bk={bk} != 0")
    return swa_attention(q, k, v, window=window, scale=scale, use_kernel=use_kernel)
