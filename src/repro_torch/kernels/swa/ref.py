"""Plain PyTorch versions of K6: causal sliding-window (GQA) attention and
its backward.

Position ``i`` attends to positions ``j`` with ``i - W < j <= i`` (window
``W``; ``W >= S`` is plain causal attention).  :func:`swa_ref` is op for op
the JAX package's ``kernels/swa/ref.py::swa_ref``; :func:`swa_lse_ref` adds
the rows' log-sum-exp; :func:`swa_backward_ref` is its gradient written out (the reference has no backward kernel: it
differentiates its plain attention).
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


def swa_lse_ref(q, k, v, *, window: int, scale: float | None = None):
    """:func:`swa_ref` and each row's log-sum-exp of the scaled, masked
    logits, ``(B, H, T)`` float32: the plain version of K6's float32
    forward with ``return_lse=True``."""
    B, H, T, D = q.shape
    S = k.shape[2]
    g = H // k.shape[1]
    scale = (D ** -0.5) if scale is None else scale
    logits = torch.einsum("bhtd,bhsd->bhts", q * scale,
                          torch.repeat_interleave(k, g, dim=1)).float()
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    lse = torch.logsumexp(torch.where(mask, logits, logits.new_full((), -torch.inf)), dim=-1)
    return swa_ref(q, k, v, window=window, scale=scale), lse


def swa_backward_ref(q, k, v, do, *, window: int, scale: float | None = None):
    """Plain version of K6's backward: ``(dq, dk, dv)`` of :func:`swa_ref`
    for the output gradient ``do`` (B, H, T, D), from the attention-gradient
    formulas in float32:

        P = softmax(scale q k^T) under the mask,  dV = P^T dO,
        dP = dO V^T,  dS = P (dP - rowsum(dO O)),
        dQ = scale dS K,  dK = scale dS^T Q,

    dK and dV summed over the q heads of each kv head.  Returned in q's,
    k's and v's dtype."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    g = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    kr = torch.repeat_interleave(kf, g, dim=1)
    vr = torch.repeat_interleave(vf, g, dim=1)
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    logits = torch.einsum("bhtd,bhsd->bhts", qf * scale, kr)
    p = torch.softmax(torch.where(mask, logits, logits.new_full((), -torch.inf)), dim=-1)
    o = torch.einsum("bhts,bhsd->bhtd", p, vr)
    dv = torch.einsum("bhts,bhtd->bhsd", p, gf)
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vr)
    ds = p * (dp - (gf * o).sum(-1, keepdim=True))
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kr) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf) * scale
    dk = dk.reshape(B, Hkv, g, S, D).sum(2)
    dv = dv.reshape(B, Hkv, g, S, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
