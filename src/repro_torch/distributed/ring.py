"""Ring attention and the log-sum-exp combine of sharded decode attention.

The port's twin of the JAX package's ``distributed/ring.py``.  Ring
attention is the iterated form of the paper's halo update: K/V blocks
rotate around the ring of sequence shards (:func:`repro_torch.core.comm.
shift`, periodic) while each rank folds a flash-style partial softmax of
the resident block into its accumulators.  Used for the full-attention
layers under context parallelism (gemma3's global layers, jamba's
attention layers).

Of the R steps, the diagonal one (the rank's own block) is causal within
the block: it runs on K6 (:func:`repro_torch.kernels.swa.swa_attention`
with ``return_lse``, window = T: plain causal attention), whose float32
kernel writes the rows' log-sum-exp, and ``(o, lse)`` is the partial
``(acc, m, l) = (o, lse, 1)``.  The blocks of earlier ranks are seen
whole: K6's contract (the queries the last T of S keys, causal) cannot
express a block every query sees, and the reference computes every step
outside any Pallas kernel, so these stay plain partial attention in
PyTorch, as in the reference.  The blocks of later ranks are masked
entirely and skipped: the reference's combine adds exactly zero for them.

K6's bfloat16 kernel writes no log-sum-exp, so the ring takes float32
only (``use_kernel="ref"`` takes any dtype on the plain path).

The decode combine (flash-decoding) comes in two forms: the reference's
:func:`lse_combine_decode` over the default group's axis, and
:func:`lse_combine_decode_over` over a ``comm`` subgroup, which serving
under sharding rules runs on a cache split over ``cache_seq``
(``models/attention.py``) and one process runs on its whole cache.  Both
are plain PyTorch on every device: the reference has no kernel for them.
"""

from __future__ import annotations

import torch

from ..core import comm
from ..kernels import dispatch
from ..kernels.swa import swa_attention
from . import axis

BF16_LSE = "ROADMAP.md, Queue B, B5: K6's bfloat16 log-sum-exp"


def _partial_attn(q, k, v, scale):
    """Flash-style partials of q: (B,Hkv,g,T,D) over a block every query
    sees, k/v: (B,Hkv,S,D).  Returns (acc, m, l): un-normalised weighted
    values, row max, row sum, float32."""
    logits = torch.einsum("bkgtd,bksd->bkgts", q * scale, k).float()
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return acc, m, l


def ring_attention(q, k, v, *, axis_name: str, causal: bool = True,
                   scale: float | None = None, use_kernel: str = "auto"):
    """Causal ring attention over sequence shards.

    q: (B, H, T_local, D); k/v: (B, Hkv, T_local, D), this process's shard
    of a sequence sharded over the group in rank order.  Returns
    (B, H, T_local, D).  ``causal=False`` attends to every block, all on
    the plain path."""
    if q.dtype != torch.float32 and use_kernel != "ref":
        raise NotImplementedError(
            f"ring_attention: the diagonal step is K6's float32 kernel with its log-sum-exp, "
            f"which the bfloat16 kernel does not write; got {q.dtype} ({BF16_LSE}; "
            "use_kernel='ref' runs the plain path)")
    dispatch.resolve(use_kernel, q, where="ring.ring_attention")   # raises on a bad mode
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    n = axis.size(axis_name)
    r = axis.index(axis_name)
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, Hkv, g, T, D)

    acc = m = l = None
    kb, vb = k, v
    for i in range(n):
        src = (r - i) % n   # the rank whose kv block is resident at step i
        if i:   # rotate kv: the block of rank r - i arrives
            kb = axis.ppermute_shift(kb, axis_name, 1, periodic=True)
            vb = axis.ppermute_shift(vb, axis_name, 1, periodic=True)
        if causal and src > r:
            continue   # masked whole: the reference's combine adds exactly zero
        if causal and src == r:
            o, lse = swa_attention(q, kb, vb, window=T, scale=scale, use_kernel=use_kernel,
                                   return_lse=True)
            mb = lse.reshape(B, Hkv, g, T, 1)
            a, lb = o.float().reshape(B, Hkv, g, T, D), torch.ones_like(mb)
        else:
            a, mb, lb = _partial_attn(qg, kb, vb, scale)
        if acc is None:
            acc, m, l = a, mb, lb
            continue
        m_new = torch.maximum(m, mb)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(mb - m_new)
        acc = acc * alpha + a * beta
        l = l * alpha + lb * beta
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, H, T, D).to(q.dtype)


def _decode_partials(qg, k, v, valid, scale, attn_softcap=0.0):
    """Flash-decoding's partial softmax of qg: (B, Hkv, g, D) over the slots
    of k/v: (B, S, Hkv, D) where ``valid`` (broadcastable to (B, S)) holds.
    Returns (acc, m, l): un-normalised weighted values, row max, row sum,
    float32."""
    logits = torch.einsum("bkgd,bskd->bkgs", qg * scale, k).float()
    if attn_softcap:
        logits = torch.tanh(logits / attn_softcap) * attn_softcap
    vmask = valid[:, None, None, :] if valid.ndim == 2 else valid
    logits = torch.where(vmask, logits, logits.new_full((), -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(logits - m), logits.new_zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return acc, m, l


def lse_combine_decode(q, k_shard, v_shard, kv_len_local, *, axis_name: str,
                       first_valid=None, scale: float | None = None):
    """Flash-decoding: one query token against a length-sharded KV cache.

    q: (B, H, D); k/v_shard: (B, S_local, Hkv, D); kv_len_local: (B,) the
    valid slots of this shard.  Each rank computes a partial softmax over
    its shard; the partials combine with log-sum-exp weights through a max
    and two sums over the group (O(H) values each, not the cache).
    ``first_valid``: this rank's first valid slot, broadcastable to
    (B, S_local).  The plain path on every device: there is no kernel."""
    B, H, D = q.shape
    Hkv = k_shard.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    slots = torch.arange(k_shard.shape[1], device=q.device)[None, :]
    valid = slots < kv_len_local[:, None]   # (B, S_local)
    if first_valid is not None:
        valid = valid & (slots >= torch.as_tensor(first_valid, device=q.device))
    acc, m, l = _decode_partials(q.reshape(B, Hkv, H // Hkv, D), k_shard, v_shard, valid, scale)
    # global combine
    m_g = axis.pmax(m, axis_name)
    w = torch.exp(m - m_g)
    acc = axis.psum(acc * w, axis_name)
    l_g = axis.psum(l * w, axis_name)
    out = acc / torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return out.reshape(B, H, D).to(q.dtype)


def decode_valid(slots, pos, S: int, ring: bool):
    """The cache slots a decode step at position ``pos`` (a 0-d tensor)
    attends to, from their GLOBAL indices ``slots`` in a cache of ``S``
    slots: those written so far (``slots <= pos``), or every slot of a
    ring buffer once it is full (``pos >= S``: a window layer's).  Global
    indices mask a shard right wherever the first valid slot lies."""
    valid = slots <= pos
    return valid | (pos >= S) if ring else valid


def lse_combine_decode_over(q, k_shard, v_shard, valid, sub, *, scale: float | None = None,
                            attn_softcap: float = 0.0):
    """Flash-decoding over a process subgroup: :func:`lse_combine_decode`
    with the shards of the cache's slots spread over ``sub`` (a
    ``comm.Subgroup``; None: one process holds every slot).

    q: (B, H, D), every head; k/v_shard: (B, S_local, Hkv, D), this
    process's slots; ``valid``: (S_local,) or (B, S_local), which of them
    the token attends to (:func:`decode_valid` on their global indices).
    The partials combine through ``comm.max_over`` of the row maxima and
    one ``comm.sum_over`` of the weighted values and sums (O(H D) values,
    not the cache).  Returns (B, H, D) in q's dtype.  The plain path on
    every device, as the reference's (no kernel)."""
    B, H, D = q.shape
    Hkv = k_shard.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    acc, m, l = _decode_partials(q.reshape(B, Hkv, H // Hkv, D), k_shard, v_shard, valid, scale,
                                 attn_softcap)
    if sub is not None:
        m_g = comm.max_over(m, sub)
        w = torch.exp(m - m_g)
        both = comm.sum_over(torch.cat([acc * w, l * w], dim=-1), sub)
        acc, l = both[..., :D], both[..., D:]
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, H, D).to(q.dtype)


__all__ = ["decode_valid", "lse_combine_decode", "lse_combine_decode_over", "ring_attention"]
