"""Mamba-2 block (SSD mixer): in_proj -> causal conv -> selective SSM -> gate.

The port's twin of the JAX package's ``models/ssm.py``.  The SSD scan is
:func:`repro_torch.kernels.ssd.ssd_scan`: the kernel K7 on the card.
Unlike the reference, which repeats the grouped B/C per head before the
scan for its tensor-parallel sharding, the port passes grouped B/C on: K7
maps head h to group ``h // (H // G)``, which gives the same result and
saves two per-head copies of B/C per layer (2 x 134 MB at 4 x 2048 tokens
of mamba2-1.3b in bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.seqpar import seq_conv1d_causal, seq_ssd_scan
from ..kernels.ssd import ssd_decode_step, ssd_scan
from .layers import rms_norm
from .params import ParamSpec


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, H, conv_dim


def specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H  # z, xBC, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("fsdp", "ffn")),
        "conv_w": ParamSpec((s.conv_kernel, conv_dim), (None, None)),
        "conv_b": ParamSpec((conv_dim,), (None,), "zeros"),
        "A_log": ParamSpec((H,), (None,), "zeros"),   # A = -exp(A_log) ~ -1
        "D": ParamSpec((H,), (None,), "ones"),
        "dt_bias": ParamSpec((H,), (None,), "zeros"),
        "norm_w": ParamSpec((d_in,), (None,), "ones"),
        "out_proj": ParamSpec((d_in, d), ("ffn", "fsdp")),
    }


class Mamba2(nn.Module):
    """The mixer's parameters.  ``in_proj`` and ``out_proj`` are
    ``nn.Linear`` (weight ``(out, in)``, the transpose of the reference's
    ``(in, out)`` leaf); the others have the reference's shapes.  Built on
    the meta device; the model assigns the real tensors."""

    def __init__(self, cfg):
        super().__init__()
        sp = specs(cfg)
        meta = {"device": "meta"}
        self.in_proj = nn.Linear(*sp["in_proj"].shape, bias=False, **meta)
        self.out_proj = nn.Linear(*sp["out_proj"].shape, bias=False, **meta)
        for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w"):
            self.register_parameter(
                name, nn.Parameter(torch.empty(sp[name].shape, **meta), requires_grad=False))


def _split(cfg, zxbcdt):
    d_in, H, conv_dim = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in : d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim :]
    return z, xBC, dt


def fwd(m: Mamba2, cfg, x, *, mode, cache=None, seq_axis: str | None = None,
        use_kernel: str = "auto"):
    """x: (B, T, d).  Returns (out, new_cache).

    seq_axis: x is this process's shard of a sequence sharded over the
    processes of the default group (context parallelism): the conv takes
    its K-1 token halo from the left neighbour and the SSD scan its
    entering state from the ranks before (``distributed.seqpar``).

    cache (decode): {"conv": (B, K-1, conv_dim), "ssm": (B, H, N, P)}: the
    conv cache holds the pre-activation ``xBC`` of the last K-1 tokens, the
    SSM cache the state in x's dtype (read back in float32)."""
    s = cfg.ssm
    B, T, d = x.shape
    d_in, H, conv_dim = _dims(cfg)
    N, G, P = s.d_state, s.n_groups, s.head_dim

    zxbcdt = F.linear(x, m.in_proj.weight)
    z, xBC, dt = _split(cfg, zxbcdt)
    A = -torch.exp(m.A_log.float())

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        conv_st = cache["conv"]  # (B, K-1, conv_dim)
        window = torch.cat([conv_st, xBC], dim=1)  # (B, K, conv_dim)
        # window[k]: oldest..current; the conv applies w[j] to x[t-j], so
        # the current token takes w[0] -> flip w along taps
        xBC_t = torch.einsum("bkc,kc->bc", window, m.conv_w.flip(0)) + m.conv_b
        xBC_t = F.silu(xBC_t)
        new_conv = window[:, 1:]
        xs = xBC_t[..., :d_in].reshape(B, H, P)
        Bs = xBC_t[..., d_in : d_in + G * N].reshape(B, G, N)
        Cs = xBC_t[..., d_in + G * N :].reshape(B, G, N)
        dt_t = F.softplus(dt[:, 0].float() + m.dt_bias)
        y, h_new = ssd_decode_step(cache["ssm"].float(), xs.float(), dt_t, A, Bs, Cs)
        y = y + m.D[None, :, None] * xs
        y = y.reshape(B, 1, d_in).to(x.dtype)
        new_cache = dict(cache, conv=new_conv, ssm=h_new.to(cache["ssm"].dtype))
    else:
        xBC_c = seq_conv1d_causal(xBC, m.conv_w, axis_name=seq_axis)
        xBC_c = F.silu(xBC_c + m.conv_b)
        xs = xBC_c[..., :d_in].reshape(B, T, H, P)
        Bs = xBC_c[..., d_in : d_in + G * N].reshape(B, T, G, N)
        Cs = xBC_c[..., d_in + G * N :].reshape(B, T, G, N)
        dtp = F.softplus(dt.float() + m.dt_bias)
        if seq_axis is not None:   # the states' halo: a doubling scan across the shards
            y, h_fin = seq_ssd_scan(xs, dtp, A, Bs, Cs, chunk=s.chunk, axis_name=seq_axis,
                                    use_kernel=use_kernel)
        else:
            y, h_fin = ssd_scan(xs, dtp, A, Bs, Cs, chunk=min(s.chunk, T),
                                use_kernel=use_kernel)
        y = y + m.D[None, None, :, None] * xs
        y = y.reshape(B, T, d_in)
        new_cache = None
        if mode == "prefill":
            K = s.conv_kernel
            pad = xBC.new_zeros(B, max(0, K - 1 - T), conv_dim)
            # the conv state holds the PRE-activation stream (post in_proj)
            new_cache = {
                "conv": torch.cat([pad, xBC[:, -(K - 1):]], dim=1),
                "ssm": h_fin.to(x.dtype),
            }

    y = rms_norm(y * F.silu(z), m.norm_w, cfg.norm_eps)
    out = F.linear(y, m.out_proj.weight)
    return out, new_cache


def init_cache_specs(cfg, batch: int, dtype) -> dict:
    """The decode cache's shapes and dtype, as meta tensors (no memory)."""
    s = cfg.ssm
    d_in, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.empty((batch, s.conv_kernel - 1, conv_dim), dtype=dtype, device="meta"),
        "ssm": torch.empty((batch, H, s.d_state, s.head_dim), dtype=dtype, device="meta"),
    }
