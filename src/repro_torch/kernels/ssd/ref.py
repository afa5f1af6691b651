"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) layer.

Selective state-space recurrence (per batch b, head h):

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T      h: (N, P)
    y_t = C_t^T h_t                                          y: (P,)

Op for op the JAX package's ``kernels/ssd/ref.py``: :func:`ssd_ref` is the
naive sequential scan, :func:`ssd_chunked_ref` the chunk-parallel SSD form,
:func:`ssd_decode_step` one token of the recurrence.
:func:`ssd_intra_chunk_ref` is the plain version of the kernel K7 with the
contract of the reference's ``ssd_intra_chunk_pallas``, and
:func:`ssd_intra_chunk_backward_ref` that of K7's backward (its gradient
written out as products; the reference has no backward kernel, it
differentiates its plain scan).  B and C are
grouped, ``(Ba, T, G, N)`` with ``H % G == 0``; head ``h`` reads group
``h // (H // G)``.
"""

from __future__ import annotations

import torch


def _per_head(B, H: int, axis: int):
    """Grouped B/C -> per head (``jnp.repeat`` along the group axis)."""
    return torch.repeat_interleave(B, H // B.shape[axis], dim=axis)


def ssd_ref(x, dt, A, B, C, h0=None):
    """Naive scan.

    x: (Ba, T, H, P); dt: (Ba, T, H); A: (H,) (negative);
    B, C: (Ba, T, G, N) with H % G == 0; h0: (Ba, H, N, P) or None.
    Returns y: (Ba, T, H, P), h_final: (Ba, H, N, P).
    """
    Ba, T, H, P = x.shape
    N = B.shape[3]
    Bh, Ch = _per_head(B, H, 2), _per_head(C, H, 2)
    dA = torch.exp(dt * A[None, None, :])  # (Ba, T, H)
    h = x.new_zeros(Ba, H, N, P) if h0 is None else h0
    ys = []
    for t in range(T):
        h = h * dA[:, t, :, None, None] + (
            (dt[:, t, :, None] * Bh[:, t])[..., :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t].to(h.dtype), h))
    return torch.stack(ys, dim=1), h


def ssd_chunked_ref(x, dt, A, B, C, chunk: int = 16, h0=None):
    """Chunk-parallel SSD (Mamba-2 Alg. 1 as dense products).  Same contract
    as :func:`ssd_ref`."""
    Ba, T, H, P = x.shape
    N = B.shape[3]
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    nc = T // chunk
    Bh, Ch = _per_head(B, H, 2), _per_head(C, H, 2)

    L = chunk
    xc = x.reshape(Ba, nc, L, H, P)
    dtc = dt.reshape(Ba, nc, L, H)
    Bc = Bh.reshape(Ba, nc, L, H, N)
    Cc = Ch.reshape(Ba, nc, L, H, N)
    logdA = dtc * A[None, None, None, :]  # (Ba, nc, L, H)
    s = torch.cumsum(logdA, dim=2)  # inclusive

    # intra-chunk: Y_diag[t] = sum_{j<=t} exp(s_t - s_j) (C_t . B_j) dt_j x_j
    decay = torch.exp(s[:, :, :, None, :] - s[:, :, None, :, :])  # (Ba,nc,L_t,L_j,H)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], decay, decay.new_zeros(()))
    ct = torch.promote_types(Cc.dtype, Bc.dtype)
    scores = torch.einsum("bclhn,bcjhn->bcljh", Cc.to(ct), Bc.to(ct))
    w = scores * decay * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcljh,bcjhp->bclhp", w, xc.to(w.dtype))

    # chunk state contribution: sum_j exp(s_L - s_j) dt_j B_j x_j^T
    dec_end = torch.exp(s[:, :, -1:, :] - s)  # (Ba,nc,L,H)
    u = dec_end * dtc
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", u, Bc.to(u.dtype), xc.to(u.dtype))
    dA_chunk = torch.exp(s[:, :, -1, :])  # (Ba, nc, H)

    # inter-chunk recurrence over chunk states, in float32 whatever the model dtype
    h = x.new_zeros(Ba, H, N, P, dtype=torch.float32) if h0 is None else h0.float()
    dA32, st32 = dA_chunk.float(), states.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)  # the state BEFORE chunk c
        h = h * dA32[:, c, :, None, None] + st32[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (Ba, nc, H, N, P)

    # inter-chunk output: Y_off[t] = exp(s_t) C_t^T h_prev
    es = torch.exp(s)
    y_off = torch.einsum("bclh,bclhn,bchnp->bclhp", es, Cc.to(es.dtype), h_prevs.to(es.dtype))
    y = (y_diag + y_off).reshape(Ba, T, H, P)
    return y.to(x.dtype), h.to(x.dtype)


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrent step for serving.

    h: (Ba, H, N, P); x_t: (Ba, H, P); dt_t: (Ba, H); B_t/C_t: (Ba, G, N).
    Returns (y_t: (Ba, H, P), h_new)."""
    H = x_t.shape[1]
    Bh, Ch = _per_head(B_t, H, 1), _per_head(C_t, H, 1)
    dA = torch.exp(dt_t * A[None, :])
    h = h * dA[..., None, None] + (dt_t[..., None] * Bh)[..., :, None] * x_t[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(h.dtype), h)
    return y, h


def chunk_logdecay(dt, A, chunk: int):
    """``s``: the in-chunk inclusive cumulative sum of ``dt * A`` in float32,
    ``(Ba, nc, L, H)`` — computed outside K7, as the reference does."""
    Ba, T, H = dt.shape
    logdA = dt.float() * A.float()[None, None, :]
    return torch.cumsum(logdA.reshape(Ba, T // chunk, chunk, H), dim=2)


def ssd_intra_chunk_ref(x, dt, A, B, C, *, chunk: int = 64):
    """Plain version of K7, the intra-chunk SSD block.

    x: (Ba, T, H, P); dt: (Ba, T, H); A: (H,); B/C: (Ba, T, G, N), G | H
    (G = H is the reference's per-head form).  Returns
    ``(y_diag (Ba, T, H, P) in x's dtype, states (Ba, nc, H, N, P) float32,
    s (Ba, nc, L, H) float32)``, the reference's
    ``ssd_intra_chunk_pallas`` contract, computed as its kernel body does:
    every product in float32, the decay selected (never multiplied) by the
    causal mask."""
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if T % chunk:
        raise ValueError(f"T={T} % chunk={chunk} != 0")
    if H % G:
        raise ValueError(f"H={H} is not a multiple of the groups G={G}")
    L, nc = chunk, T // chunk
    s = chunk_logdecay(dt, A, chunk)  # (Ba, nc, L, H)

    def cells(a, d):  # (Ba, T, H, d) -> (Ba, nc, H, L, d)
        return a.reshape(Ba, nc, L, H, d).permute(0, 1, 3, 2, 4)

    xf = cells(x, P).float()
    Bf = cells(_per_head(B, H, 2), N).float()
    Cf = cells(_per_head(C, H, 2), N).float()
    dtf = dt.float().reshape(Ba, nc, L, H).permute(0, 1, 3, 2)  # (Ba, nc, H, L)
    sc = s.permute(0, 1, 3, 2)  # (Ba, nc, H, L)

    scores = Cf @ Bf.transpose(-1, -2)  # (.., L_t, L_j)
    decay = torch.exp(sc[..., :, None] - sc[..., None, :])  # s_t - s_j
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    w = torch.where(tri, scores * decay, scores.new_zeros(())) * dtf[..., None, :]
    y_diag = (w @ xf).to(x.dtype)  # (Ba, nc, H, L, P)

    dec_end = torch.exp(sc[..., L - 1 :] - sc)  # (Ba, nc, H, L)
    bw = Bf * (dec_end * dtf)[..., None]  # (.., L, N)
    states = bw.transpose(-1, -2) @ xf  # (Ba, nc, H, N, P)
    y_diag = y_diag.permute(0, 1, 3, 2, 4).reshape(Ba, T, H, P)
    return y_diag, states, s


def ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dstates):
    """Plain version of K7's backward: the gradient of
    :func:`ssd_intra_chunk_ref`'s ``(y_diag, states)`` for the cotangents
    ``dy`` (Ba, T, H, P) and ``dstates`` (Ba, nc, H, N, P), with ``s``
    (Ba, nc, L, H) an input of its own (``chunk_logdecay`` stays outside,
    so autograd carries ``ds`` into dt and A).

    Per cell, with ``W = tril(C B^T o e^{s_t - s_j}) o dt_j`` and ``u_j =
    e^{s_{L-1} - s_j} dt_j``, written out as products (not autograd)::

        dW  = tril(dY X^T)                M = dW o decay o dt_j
        dX  = W^T dY + (u o B) dS         dC = M B
        dB  = M^T C + u o (X dS^T)
        ddt_j = sum_t (dW o C B^T o decay)_tj + e^{s_{L-1} - s_j} R_j
        ds_t  = sum_j (dW o W)_tj - sum_i (dW o W)_it - E_t (+ sum_j E_j at t = L-1)

    with ``R_j = sum_n B_jn (X dS^T)_jn`` and ``E_j = u_j R_j``; ``ddt`` is
    the direct part only.  Every product in float32.  Returns ``(dx in x's
    dtype, ddt (Ba, T, H), ds (Ba, nc, L, H), dB, dC (Ba, T, G, N) in B's
    dtype)``: dB and dC summed over each group's heads (the adjoint of the
    per-head repeat)."""
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, L = s.shape[1], s.shape[2]

    def cells(a, d):  # (Ba, T, H, d) -> (Ba, nc, H, L, d)
        return a.reshape(Ba, nc, L, H, d).permute(0, 1, 3, 2, 4).float()

    def tokens(a):  # (Ba, nc, H, L, d) -> (Ba, T, H, d)
        return a.permute(0, 1, 3, 2, 4).reshape(Ba, T, H, a.shape[-1])

    xf, dyf = cells(x, P), cells(dy, P)
    Bf, Cf = cells(_per_head(B, H, 2), N), cells(_per_head(C, H, 2), N)
    dS = dstates.float()  # (Ba, nc, H, N, P)
    dtf = dt.float().reshape(Ba, nc, L, H).permute(0, 1, 3, 2)  # (Ba, nc, H, L)
    sc = s.float().permute(0, 1, 3, 2)

    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    zero = xf.new_zeros(())
    decay = torch.where(tri, torch.exp(sc[..., :, None] - sc[..., None, :]), zero)
    gd = (Cf @ Bf.transpose(-1, -2)) * decay  # C B^T o decay, lower triangle
    w = gd * dtf[..., None, :]
    dw = torch.where(tri, dyf @ xf.transpose(-1, -2), zero)
    m = dw * decay * dtf[..., None, :]
    dec_end = torch.exp(sc[..., L - 1:] - sc)  # (.., L)
    u = dec_end * dtf
    q = xf @ dS.transpose(-1, -2)  # X dS^T, (.., L, N)

    dx = w.transpose(-1, -2) @ dyf + (Bf * u[..., None]) @ dS
    dC = m @ Bf
    dB = m.transpose(-1, -2) @ Cf + u[..., None] * q
    r = (Bf * q).sum(-1)  # R, (.., L)
    p1 = dw * gd
    ddt = p1.sum(-2) + dec_end * r
    e1 = p1 * dtf[..., None, :]  # dW o W
    e = u * r
    ds = e1.sum(-1) - e1.sum(-2) - e
    ds[..., L - 1] += e.sum(-1)

    def grouped(a):  # per head (Ba, T, H, N) -> per group (Ba, T, G, N)
        return a.reshape(Ba, T, G, H // G, N).sum(3).to(B.dtype)

    return (tokens(dx).to(x.dtype), ddt.permute(0, 1, 3, 2).reshape(Ba, T, H),
            ds.permute(0, 1, 3, 2).contiguous(), grouped(tokens(dB)), grouped(tokens(dC)))
