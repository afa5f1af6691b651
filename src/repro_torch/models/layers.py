"""Shared layers of the port's models: the RMS norm (what the Mamba-2
path calls; the rest of the reference's ``models/layers.py`` comes with
the attention slice)."""

from __future__ import annotations

import torch


def rms_norm(x, w, eps: float = 1e-6, *, scale_plus_one: bool = False):
    """RMS norm over the last axis, in float32 inside, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = w.float()
    if scale_plus_one:  # gemma convention
        wf = wf + 1.0
    return (y * wf).to(x.dtype)
