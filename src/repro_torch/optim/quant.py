"""Blockwise int8 tensor quantization (the optimizer's moments).

The port's twin of the JAX package's ``optim/quant.py``: dynamic
per-block scaling along the last axis, ``BLOCK`` = 128 elements (the last
block padded with zeros), after the 8-bit-optimizer recipe (Dettmers et
al., arXiv:2110.02861).

A moment sharded over processes (:class:`QuantShard`) keeps the blocks of
the whole leaf's last axis, as the reference's GSPMD arrays do: a block
that straddles two processes takes its scale from a max over them, and
``s`` has every block of the last axis (the reference's ``quant_specs``
leaves that axis unsharded), so the codes are the one-process codes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core import comm

BLOCK = 128


@dataclasses.dataclass(frozen=True)
class QuantShard:
    """How one process's block of a quantized leaf sits in the whole: its
    last axis is ``[off, off + local)`` of ``n`` values, split over the
    subgroup ``last`` (None: not split); ``extra``, ``(axis, subgroup)``
    pairs, are leading axes of ``s`` split further than ``q``'s (the
    reference's spec of ``s``, whose last axis is free, can hand that
    mesh axis to a leading one)."""

    off: int = 0
    n: int | None = None
    last: object = None
    extra: tuple = ()


def _nblocks(n: int) -> int:
    return -(-n // BLOCK)


def _ipow(y, p: int):
    """``y ** p`` for a positive integer ``p`` by repeated squaring, the
    products ``jax.lax.integer_pow`` takes (``y^4 = (y^2)^2``)."""
    acc = None
    while p > 0:
        if p & 1:
            acc = y if acc is None else acc * y
        p >>= 1
        if p > 0:
            y = y * y
    return acc


def _window(nl: int, shard):
    """(n, nb, first block, offset in it, blocks touched) of a last axis of
    ``nl`` local values."""
    off = shard.off if shard is not None else 0
    n = shard.n if shard is not None and shard.n is not None else nl
    lo = off % BLOCK
    return n, _nblocks(n), off // BLOCK, lo, _nblocks(lo + nl)


def quantize(x, p: int = 1, shard: QuantShard | None = None) -> dict:
    """x: (..., n) floating -> ``{"q": int8 (..., n), "s": float32 (..., nblocks)}``.

    ``p`` picks the code: 1 linear (absolute error at most s/127, for the
    first moment), 4 the power law ``x = sign(q) s (|q|/127)^4`` (relative
    resolution over ~9 decades, for the second moment).  A block of zeros
    takes the scale 1.  Codes are rounded half to even, as ``jnp.round``
    rounds.  ``shard``: ``x`` is a process's block (see :class:`QuantShard`;
    collective where the last axis is split)."""
    nl = x.shape[-1]
    n, nb, b0, lo, nbl = _window(nl, shard)
    xb = F.pad(x.float(), (lo, nbl * BLOCK - lo - nl)).reshape(*x.shape[:-1], nbl, BLOCK)
    s = xb.abs().amax(dim=-1)
    if shard is not None and shard.last is not None and shard.last.size > 1:
        whole = s.new_zeros(*x.shape[:-1], nb)
        whole[..., b0:b0 + nbl] = s
        whole = comm.max_over(whole, shard.last)
        s = whole[..., b0:b0 + nbl]
    else:
        whole = s
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    whole = torch.where(whole == 0.0, torch.ones_like(whole), whole)
    y = xb / s[..., None]
    if p == 1:
        q = torch.round(127.0 * y)
    else:
        q = torch.round(127.0 * torch.sign(y) * y.abs() ** (1.0 / p))
    q = q.to(torch.int8).reshape(*x.shape[:-1], nbl * BLOCK)[..., lo:lo + nl].contiguous()
    for dim, sub in (shard.extra if shard is not None else ()):
        whole = whole.chunk(sub.size, dim)[sub.index].contiguous()
    return {"q": q, "s": whole}


def dequantize(qs: dict, p: int = 1, shard: QuantShard | None = None):
    """The float32 values of a :func:`quantize` result (``shard``: as it
    was quantized; collective where ``s`` is split further than ``q``)."""
    q, s = qs["q"], qs["s"]
    for dim, sub in (shard.extra if shard is not None else ()):
        s = comm.gather_over(s, sub, dim)
    nl = q.shape[-1]
    n, nb, b0, lo, nbl = _window(nl, shard)
    y = F.pad(q.float(), (lo, nbl * BLOCK - lo - nl)) / 127.0
    if p != 1:
        y = torch.sign(y) * _ipow(y.abs(), p)
    xb = y.reshape(*q.shape[:-1], nbl, BLOCK) * s[..., b0:b0 + nbl, None]
    return xb.reshape(*q.shape[:-1], nbl * BLOCK)[..., lo:lo + nl]


def quant_specs(shape, axes):
    """(shape, axes) pairs of the quantized form: ``q`` keeps the shape,
    ``s`` has one block axis (never sharded) in place of the last."""
    nb = _nblocks(shape[-1])
    return ((tuple(shape), tuple(axes)),
            ((*shape[:-1], nb), (*axes[:-1], None)))
