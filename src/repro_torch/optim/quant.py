"""Blockwise int8 tensor quantization (the optimizer's moments).

The port's twin of the JAX package's ``optim/quant.py``: dynamic
per-block scaling along the last axis, ``BLOCK`` = 128 elements (the last
block padded with zeros), after the 8-bit-optimizer recipe (Dettmers et
al., arXiv:2110.02861).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 128


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


def quantize(x, p: int = 1) -> dict:
    """x: (..., n) floating -> ``{"q": int8 (..., n), "s": float32 (..., nblocks)}``.

    ``p`` picks the code: 1 linear (absolute error at most s/127, for the
    first moment), 4 the power law ``x = sign(q) s (|q|/127)^4`` (relative
    resolution over ~9 decades, for the second moment).  A block of zeros
    takes the scale 1.  Codes are rounded half to even, as ``jnp.round``
    rounds."""
    n = x.shape[-1]
    nb = _nblocks(n)
    xb = F.pad(x.float(), (0, nb * BLOCK - n)).reshape(*x.shape[:-1], nb, BLOCK)
    s = xb.abs().amax(dim=-1)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    y = xb / s[..., None]
    if p == 1:
        q = torch.round(127.0 * y)
    else:
        q = torch.round(127.0 * torch.sign(y) * y.abs() ** (1.0 / p))
    q = q.to(torch.int8).reshape(*x.shape[:-1], nb * BLOCK)[..., :n].contiguous()
    return {"q": q, "s": s}


def dequantize(qs: dict, p: int = 1):
    """The float32 values of a :func:`quantize` result."""
    q, s = qs["q"], qs["s"]
    n, nb = q.shape[-1], s.shape[-1]
    y = F.pad(q.float(), (0, nb * BLOCK - n)) / 127.0
    if p != 1:
        y = torch.sign(y) * _ipow(y.abs(), p)
    xb = y.reshape(*q.shape[:-1], nb, BLOCK) * s[..., None]
    return xb.reshape(*q.shape[:-1], nb * BLOCK)[..., :n]


def quant_specs(shape, axes):
    """(shape, axes) pairs of the quantized form: ``q`` keeps the shape,
    ``s`` has one block axis (never sharded) in place of the last."""
    nb = _nblocks(shape[-1])
    return ((tuple(shape), tuple(axes)),
            ((*shape[:-1], nb), (*axes[:-1], None)))
