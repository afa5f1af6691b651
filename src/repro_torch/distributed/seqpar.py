"""Halo-exchange sequence parallelism: the paper's technique on the token grid.

The port's twin of the JAX package's ``distributed/seqpar.py``.  The
sequence is a 1-D grid sharded over the processes of the default
``torch.distributed`` group (:mod:`.axis`: the reference's ``axis_name``
stands for that group).  Operators with a local receptive field need only
a thin halo of neighbour tokens:

* causal depthwise conv (Mamba, K = 4)     -> a left halo of K-1 tokens;
* sliding-window attention (window W)      -> a left halo of W tokens;
* the SSD chunk states across ranks        -> a halo on the chunk-state
  grid, generalised to a log2(R)-step doubling scan.

Every function takes this process's shard, time on axis 1 ((B, T_local,
...); attention (B, H, T_local, D)), and every process of the group calls
it in the same order.  The neighbour traffic is :func:`repro_torch.core.
comm.shift`, the port's ``ppermute``.  Without a group each function
computes the whole-sequence answer.  The kernels run where the reference
calls its kernels' ops: the attention of a shard is K6
(:func:`repro_torch.kernels.swa.swa_attention`), the local scan K7
(:func:`repro_torch.kernels.ssd.ssd_scan`).
"""

from __future__ import annotations

import torch

from ..kernels.ssd import ssd_scan
from ..kernels.swa import swa_attention
from . import axis


def halo_left(x, width: int, axis_name: str):
    """Left halo: the last ``width`` tokens of the left neighbour (zeros on
    rank 0).  x: (B, T_local, ...); returns (B, width, ...)."""
    if width > x.shape[1]:
        raise ValueError(
            f"halo width {width} > local sequence {x.shape[1]}; "
            "increase the shard size or use ring attention"
        )
    return axis.ppermute_shift(x[:, x.shape[1] - width:], axis_name, 1)


def seq_conv1d_causal(x, w, axis_name: str | None = None):
    """Causal depthwise conv over a (possibly sequence-sharded) stream.
    x: (B, T, C); w: (K, C).  With ``axis_name`` the K-1 left context comes
    from the neighbour shard (zeros on rank 0): the paper's halo update on
    the token grid.

    Written as the reference's K-tap sum, in the same order, and not as
    ``F.conv1d``: a float32 convolution on the card runs through cuDNN in
    TF32 by default, and the prefill path would then differ from the decode
    step, which applies the same taps one token at a time.

    Without ``axis_name`` the left pad is always K-1 zeros.  The reference
    pads with ``zeros_like(x[:, :K-1])``, which has only T rows when
    T < K-1: its output there reads later tokens (T = 2) or is empty
    (T = 1).  For T >= K-1 the two are the same."""
    K = w.shape[0]
    T = x.shape[1]
    if axis_name is None:
        pad = x.new_zeros(x.shape[0], K - 1, *x.shape[2:])
    else:
        pad = halo_left(x, K - 1, axis_name)
    xx = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xx[:, k : k + T] * w[K - 1 - k][None, None, :]
    return out


def seq_sliding_window_attention(q, k, v, *, window: int, axis_name: str,
                                 scale: float | None = None, use_kernel: str = "auto"):
    """Sequence-parallel causal sliding-window attention through a kv halo.

    q: (B, H, T_local, D); k/v: (B, Hkv, T_local, D), this process's
    shard.  Needs window <= T_local (one hop of halo).  Every rank but the
    first puts the W-token halo of K and V before its own and calls K6's
    dispatch point with the queries the last T of T + W keys, so that the
    halo's keys sit at their absolute positions.  The first rank passes its
    own keys alone: the reference masks its zero halo off through the
    absolute positions (``kv_abs >= 0``), and an S = T call is that."""
    T = q.shape[2]
    if window > T:
        raise ValueError("window spans more than one neighbor shard; chain halos")
    # halo_left wants (B, T, ...): move heads behind time
    kh = halo_left(k.transpose(1, 2), window, axis_name).transpose(1, 2)
    vh = halo_left(v.transpose(1, 2), window, axis_name).transpose(1, 2)
    if axis.index(axis_name) > 0:
        k = torch.cat([kh, k], dim=2)
        v = torch.cat([vh, v], dim=2)
    return swa_attention(q, k, v, window=window, scale=scale, use_kernel=use_kernel)


def _seg_combine(earlier, later):
    """Compose SSD segments: apply ``earlier`` then ``later`` to a state.

    Segment (P, S): h -> P * h + S  (P broadcasts over the state dims)."""
    P1, S1 = earlier
    P2, S2 = later
    return (P1 * P2, P2[..., None, None] * S1 + S2)


def rank_prefix_scan(Ptot, h_local, axis_name: str):
    """Exclusive associative scan of (decay, state) segments across ranks.

    Ptot: (Ba, H) total segment decay; h_local: (Ba, H, N, P) segment state
    (float32).  Returns ``(h_in, P_in)``: the state entering this rank (for
    h0 = 0) and the combined decay before it, by log2(R) shifts
    (Hillis-Steele doubling), as the reference computes them."""
    n = axis.size(axis_name)
    r = axis.index(axis_name)
    # shift right: acc[r] = seg[r-1], identity at rank 0
    accP = axis.ppermute_shift(Ptot, axis_name, 1)
    accS = axis.ppermute_shift(h_local, axis_name, 1)   # zeros at rank 0 = identity
    if r == 0:
        accP = torch.ones_like(accP)
    # inclusive doubling scan => acc[r] = seg[0] o ... o seg[r-1]
    shift = 1
    while shift < n:
        inP = axis.ppermute_shift(accP, axis_name, shift)
        inS = axis.ppermute_shift(accS, axis_name, shift)
        if r < shift:
            inP, inS = torch.ones_like(inP), torch.zeros_like(inS)
        accP, accS = _seg_combine((inP, inS), (accP, accS))
        shift *= 2
    return accS, accP


def seq_ssd_scan(x, dt, A, B, C, *, chunk: int, axis_name: str, use_kernel: str = "auto"):
    """Sequence-parallel SSD scan.

    Shapes as in :func:`repro_torch.kernels.ssd.ssd_scan` with T = T_local
    (B/C grouped, (Ba, T, G, N)).  The local scan runs on this shard alone
    (K7 on a CUDA tensor), its final state and total decay enter the rank
    scan, and the state entering the shard corrects y:
    ``y_t += exp(s_t) C_t^T h_in``.  Returns ``(y, h_out)``, h_out this
    rank's outgoing state (the global final state lives on the last rank)."""
    y_local, h_local = ssd_scan(x, dt, A, B, C, chunk=chunk, use_kernel=use_kernel)
    logdA_t = dt.float() * A.float()[None, None, :]
    Ptot = torch.exp(logdA_t.sum(dim=1))   # (Ba, H)

    h_in, _ = rank_prefix_scan(Ptot, h_local.float(), axis_name)

    # correction: y_t += exp(s_t) * C_t^T h_in, C grouped (head h reads group h // (H/G))
    s = torch.cumsum(logdA_t, dim=1)   # (Ba, T, H)
    Ba, T, H, P = x.shape
    G, N = C.shape[2], C.shape[3]
    y_corr = torch.einsum("btgn,bgjnp->btgjp", C.float(), h_in.reshape(Ba, G, H // G, N, P))
    y_corr = torch.exp(s)[..., None] * y_corr.reshape(Ba, T, H, P)
    y = y_local + y_corr.to(y_local.dtype)
    h_out = Ptot[..., None, None] * h_in + h_local.float()
    return y, h_out.to(h_local.dtype)


__all__ = ["halo_left", "rank_prefix_scan", "seq_conv1d_causal", "seq_ssd_scan",
           "seq_sliding_window_attention"]
