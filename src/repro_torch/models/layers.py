"""Shared layers of the port's models: the RMS norm, activations, the
gated FFN activation, rotary embeddings and the soft cap.

The port's twin of the JAX package's ``models/layers.py`` (its chunked
loss belongs to training, which the port does not have yet)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
