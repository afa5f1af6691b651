"""Shared layers of the port's models: the RMS norm, activations, the
gated FFN activation, rotary embeddings, the soft cap and the chunked
cross-entropy loss of training.

The port's twin of the JAX package's ``models/layers.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x, w, eps: float = 1e-6, *, scale_plus_one: bool = False):
    """RMS norm over the last axis, in float32 inside, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = w.float()
    if scale_plus_one:  # gemma convention
        wf = wf + 1.0
    return (y * wf).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": gelu, "silu": F.silu, "relu": F.relu}[name]


def glu(x2, kind: str):
    """x2: (..., 2, f) fused gate/up -> (..., f)."""
    g, u = x2[..., 0, :], x2[..., 1, :]
    if kind == "swiglu":
        return F.silu(g) * u
    if kind == "geglu":
        return gelu(g) * u
    raise ValueError(kind)


def rope(x, positions, theta: float):
    """Rotary embedding, rotate-half form (not interleaved), float32 inside.
    x: (..., T, H, D); positions: (..., T) or (T,)."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def _chunk_xent(hb, w_out, lb, logit_softcap: float, n_valid: int | None):
    """Summed cross-entropy of one chunk of tokens, and the count of its
    labels >= 0; the logits in float32, the vocab pad rows at -1e30."""
    logits = (hb @ w_out).float()
    if logit_softcap:
        logits = softcap(logits, logit_softcap)
    V = logits.shape[-1]
    if n_valid is not None and n_valid != V:   # mask the vocab padding
        valid_v = torch.arange(V, device=logits.device) < n_valid
        logits = torch.where(valid_v, logits, logits.new_full((), -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lb.clamp_min(0).long()[..., None])[..., 0]
    valid = lb >= 0
    return torch.sum(torch.where(valid, lse - ll, lse.new_zeros(()))), valid.sum()


def cross_entropy_chunked(h, w_out, labels, *, chunk: int = 512, logit_softcap: float = 0.0,
                          n_valid: int | None = None):
    """Mean token cross-entropy over the labels >= 0 (-100 is ignored).

    h: (B, T, d) final hidden states; w_out: (d, V) (the tied embedding,
    transposed, or the head); labels: (B, T).  The logits are made for
    ``chunk`` tokens of the sequence at a time (the whole sequence where
    ``chunk`` does not divide T), and each chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits:
    the (B, T, V) float32 logits are never held, which matters at 128-256 k
    vocabularies."""
    B, T, _ = h.shape
    chunk = min(chunk, T)
    if T % chunk:
        chunk = T   # the reference's fall-back for small shapes
    loss_sum = h.new_zeros((), dtype=torch.float32)
    n = torch.zeros((), dtype=torch.long, device=h.device)
    for c0 in range(0, T, chunk):
        hb, lb = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            s, k = checkpoint(_chunk_xent, hb, w_out, lb, logit_softcap, n_valid,
                              use_reentrant=False)
        else:
            s, k = _chunk_xent(hb, w_out, lb, logit_softcap, n_valid)
        loss_sum, n = loss_sum + s, n + k
    return loss_sum / torch.clamp_min(n, 1)
