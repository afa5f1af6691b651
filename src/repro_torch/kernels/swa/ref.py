"""Plain PyTorch version of K6: causal sliding-window (GQA) attention.

Position ``i`` attends to positions ``j`` with ``i - W < j <= i`` (window
``W``; ``W >= S`` is plain causal attention).  Op for op the JAX package's
``kernels/swa/ref.py::swa_ref``.
"""

from __future__ import annotations

import torch


def swa_ref(q, k, v, *, window: int, scale: float | None = None):
    """q: (B, H, T, D); k/v: (B, Hkv, S, D) with H % Hkv == 0.  Returns
    (B, H, T, D).

    Assumes queries are the LAST ``T`` positions of the ``S``-long kv
    sequence (T == S for self-attention prefill)."""
    B, H, T, D = q.shape
    Bk, Hkv, S, _ = k.shape
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    g = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    kr = torch.repeat_interleave(k, g, dim=1)
    vr = torch.repeat_interleave(v, g, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q * scale, kr).float()
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    logits = torch.where(mask, logits, logits.new_full((), -torch.inf))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhts,bhsd->bhtd", p.to(q.dtype), vr)
