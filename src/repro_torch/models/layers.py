"""Shared layers of the port's models: the RMS norm, activations, the
gated FFN activation, rotary embeddings, the soft cap, the chunked
cross-entropy loss of training, and the join of a row-parallel output
(:func:`row_join`).

The port's twin of the JAX package's ``models/layers.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import comm
from ..distributed import sharding


def rms_norm(x, w, eps: float = 1e-6, *, scale_plus_one: bool = False, over=None):
    """RMS norm over the last axis, in float32 inside, cast back to x's type.

    ``over``: a ``comm.Subgroup`` whose processes each hold an equal part of
    the last axis (a tensor-parallel layer's channels): the mean square is
    that of the whole axis, its sum added over them.  The sum goes through
    ``comm.copy_to(comm.sum_over(.))``, so that in the backward each
    process's part also receives the other processes' terms."""
    xf = x.float()
    if over is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ss = comm.sum_over(torch.sum(xf * xf, dim=-1, keepdim=True), over)
        var = comm.copy_to(ss, over) / (xf.shape[-1] * over.size)
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


def row_join(out, tp, seq=None):
    """The join of a row-parallel output ``out`` (B, T, d): the partial
    outputs of the processes of ``tp`` summed (``comm.sum_over``; None: a
    whole output).  ``seq``: under sequence parallelism, the subgroup that
    splits the tokens (dim 1); the join keeps this process's block of
    them, a reduce-scatter where ``seq`` is ``tp`` (the same bits: both add
    the partials in index order)."""
    if seq is None:
        return out if tp is None else comm.sum_over(out, tp)
    if tp is not None and tp.ranks == seq.ranks:
        return comm.reduce_scatter_over(out, tp, dim=1)
    if tp is not None:
        out = comm.sum_over(out, tp)
    n = out.shape[1] // seq.size
    return out[:, seq.index * n:(seq.index + 1) * n]


def _chunk_xent(hb, w_out, lb, logit_softcap: float, n_valid: int | None, vocab=None):
    """Summed cross-entropy of one chunk of tokens, and the count of its
    labels >= 0; the logits in float32, the vocab pad rows at -1e30.

    ``vocab``: ``(subgroup, offset)`` where ``w_out`` holds the columns
    ``[offset, offset + V_local)`` of a vocabulary sharded over the
    subgroup: the log-sum-exp then comes from a max and a sum over it, the
    label's logit from the process that holds it, and the padding is
    masked by global index."""
    logits = (hb @ w_out).float()
    if logit_softcap:
        logits = softcap(logits, logit_softcap)
    V = logits.shape[-1]
    sub, off = vocab if vocab is not None else (None, 0)
    if n_valid is not None and n_valid != V * (1 if sub is None else sub.size):
        valid_v = torch.arange(off, off + V, device=logits.device) < n_valid
        logits = torch.where(valid_v, logits, logits.new_full((), -1e30))
    valid = lb >= 0
    if sub is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lb.clamp_min(0).long()[..., None])[..., 0]
    else:
        m = comm.max_over(logits.detach().amax(dim=-1), sub)
        se = comm.sum_over(torch.exp(logits - m[..., None]).sum(dim=-1), sub)
        lse = m + torch.log(se)
        lab = lb.clamp_min(0).long() - off
        mine = (lab >= 0) & (lab < V)
        picked = torch.gather(logits, -1, lab.clamp(0, V - 1)[..., None])[..., 0]
        ll = comm.sum_over(torch.where(mine, picked, picked.new_zeros(())), sub)
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
    vocabularies.

    Under installed sharding rules h and labels are this process's rows of
    the batch and the logits are sharded by vocabulary, as the reference's
    ``shd(logits, "batch", None, "vocab")`` asks: ``w_out`` holds this
    process's columns, h enters through ``comm.copy_to`` (its gradient is
    summed over the vocabulary's processes), and the value returned is
    this process's share of the loss, the sum over its rows over the count
    of valid labels of the whole batch: summed over the batch's processes
    it is the global mean, and so are the gradients."""
    B, T, _ = h.shape
    chunk = min(chunk, T)
    if T % chunk:
        chunk = T   # the reference's fall-back for small shapes
    rules = sharding.current()
    vocab = None
    vsub = sharding.group_of(rules, "vocab")
    if vsub is not None:
        sharding.shd(w_out, None, "vocab", shape=(w_out.shape[0], w_out.shape[1] * vsub.size))
        vocab = (vsub, vsub.index * w_out.shape[1])
        h = comm.copy_to(h, vsub)
    loss_sum = h.new_zeros((), dtype=torch.float32)
    n = torch.zeros((), dtype=torch.long, device=h.device)
    for c0 in range(0, T, chunk):
        hb, lb = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            s, k = checkpoint(_chunk_xent, hb, w_out, lb, logit_softcap, n_valid, vocab,
                              use_reentrant=False)
        else:
            s, k = _chunk_xent(hb, w_out, lb, logit_softcap, n_valid, vocab)
        loss_sum, n = loss_sum + s, n + k
    batch = sharding.group_of(rules, "batch")
    if batch is not None:
        n = comm.sum_over(n, batch)
    return loss_sum / torch.clamp_min(n, 1)
