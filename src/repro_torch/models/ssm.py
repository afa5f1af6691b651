"""Mamba-2 block (SSD mixer): in_proj -> causal conv -> selective SSM -> gate.

The port's twin of the JAX package's ``models/ssm.py``.  The SSD scan is
:func:`repro_torch.kernels.ssd.ssd_scan`: the kernel K7 on the card.
Unlike the reference, which repeats the grouped B/C per head before the
scan for its tensor-parallel sharding, the port passes grouped B/C on: K7
maps head h to group ``h // (H // G)``, which gives the same result and
saves two per-head copies of B/C per layer (2 x 134 MB at 4 x 2048 tokens
of mamba2-1.3b in bf16).

Under installed sharding rules (training and serving) the layer is tensor-parallel
over the mesh axes that split ``out_proj``'s ``d_inner`` rows (the
``ffn`` rule): process ``r`` of ``tp`` runs heads ``[r H/tp, (r+1) H/tp)``,
the block of rows ``out_proj`` holds.  The stored layout stays the
reference's, whose ``in_proj`` column blocks do not fall on head
boundaries (its fused output is ``z | x B C | dt``): the layer gathers
``in_proj`` whole and takes its heads' z, x and dt columns and the B/C
columns of the groups they use (:func:`local_rows`); the replicated
``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` are
sliced alike (:data:`TP_PARTIAL`: their gradients, and the B/C columns',
are partial and summed over the processes).  The input passes through
``comm.copy_to``, ``out_proj`` is row-parallel (``comm.sum_over``), and
the gated RMS norm sums its mean square over the processes.  K7 and its
backward run on the local heads.  Serving keeps the reference's cache
layout: the SSM state is the local heads' (``state_heads``), the conv
state whole on every process, so prefill and decode compute the whole
``xBC`` from ``in_proj`` and take their channels from it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import comm
from ..distributed import sharding
from ..distributed.seqpar import seq_conv1d_causal, seq_ssd_scan
from ..kernels.ssd import ssd_decode_step, ssd_scan
from .layers import rms_norm, row_join
from .params import ParamSpec

# the replicated leaves a tensor-parallel process slices to its heads: their
# gradient on a process is its heads' (and its groups') share, summed over
# the heads' processes
TP_PARTIAL = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w")
# the logical axes of the cache's leaves (the reference's ``cache_axes``)
CACHE_AXES = {"conv": ("cache_batch", None, None),
              "ssm": ("cache_batch", "state_heads", None, None)}


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


def tp_axes(cfg, rules) -> tuple:
    """The mesh axes a Mamba layer's heads are split over under ``rules``
    (those of ``out_proj``'s ``d_inner`` rows; () without rules).  Raises,
    naming the shapes and the mesh, where ``d_inner`` does not split over
    every axis of the ``ffn`` rule, where the heads do not split over them
    or where a process's heads do not map onto whole groups of B/C."""
    if rules is None:
        return ()
    s, mesh = cfg.ssm, rules.mesh
    d_in, H, _ = _dims(cfg)
    sp = specs(cfg)["out_proj"]
    what = f"a Mamba layer's {H} heads (d_inner {d_in}) do not split"
    axes = sharding.split_axes(rules, sp.axes, sp.shape, 0, what)
    tp = math.prod(mesh.shape[a] for a in axes)
    if H % tp:
        raise NotImplementedError(f"{what} over the mesh axes {axes} ({dict(mesh.shape)})")
    Hl, hg = H // tp, H // s.n_groups
    if Hl % hg and hg % Hl:
        raise NotImplementedError(
            f"{Hl} Mamba heads a process do not map onto whole groups of B/C ({s.n_groups} "
            f"groups of {hg} heads) over the mesh axes {axes} ({dict(mesh.shape)})")
    return axes


def tp_group(cfg, rules):
    """The subgroup of :func:`tp_axes` (None: no rules, or one process)."""
    return sharding.subgroup(rules, tp_axes(cfg, rules))


def _local_parts(cfg, r: int, tp: int):
    """Process ``r`` of ``tp``'s heads ``(h0, h1)`` and the groups of B/C
    they use ``(g0, g1)``."""
    _, H, _ = _dims(cfg)
    Hl, hg = H // tp, H // cfg.ssm.n_groups
    return (r * Hl, (r + 1) * Hl), (r * Hl // hg, ((r + 1) * Hl - 1) // hg + 1)


def local_rows(cfg, r: int, tp: int):
    """Indices, along ``in_proj``'s fused output ``z | x B C | dt`` and along
    the conv's channels ``x B C``, of process ``r`` of ``tp``'s heads and
    groups, each part in the reference's order."""
    s = cfg.ssm
    d_in, _, _ = _dims(cfg)
    P, GN = s.head_dim, s.n_groups * s.d_state
    (h0, h1), (g0, g1) = _local_parts(cfg, r, tp)
    heads = torch.arange(h0 * P, h1 * P)
    groups = torch.arange(g0 * s.d_state, g1 * s.d_state)
    conv = torch.cat([heads, d_in + groups, d_in + GN + groups])
    proj = torch.cat([heads, d_in + conv, 2 * d_in + 2 * GN + torch.arange(h0, h1)])
    return proj, conv


def _local(m: Mamba2, cfg, sub):
    """The layer's weights for this process's heads (``sub``: the heads'
    subgroup, None: all of them): the rows of the whole ``in_proj`` weight
    to take (an index tensor, None: all) and the indices of the conv's
    channels (None: all), ``conv_w``, ``conv_b``, ``A_log``, ``D``,
    ``dt_bias``, ``norm_w``, and the local ``(d_inner, H, G)``."""
    d_in, H, _ = _dims(cfg)
    if sub is None:
        return (None, None, *(getattr(m, n) for n in TP_PARTIAL), (d_in, H, cfg.ssm.n_groups))
    proj, conv = (i.to(m.in_proj.weight.device) for i in local_rows(cfg, sub.index, sub.size))
    (h0, h1), (g0, g1) = _local_parts(cfg, sub.index, sub.size)
    P = cfg.ssm.head_dim
    return (proj, conv, m.conv_w[:, conv], m.conv_b[conv], m.A_log[h0:h1],
            m.D[h0:h1], m.dt_bias[h0:h1], m.norm_w[h0 * P:h1 * P],
            ((h1 - h0) * P, h1 - h0, g1 - g0))


def _serving_in_proj(m: Mamba2, cfg, x, sub):
    """``in_proj`` of a tensor-parallel layer when serving: this process's
    heads' z and dt, and the WHOLE ``xBC`` (every channel of the conv),
    which the conv state keeps on every process (``conv ("cache_batch",
    None, None)``); each from a contiguous block of the whole weight's
    rows."""
    d_in, _, conv_dim = _dims(cfg)
    (h0, h1), _ = _local_parts(cfg, sub.index, sub.size)
    P, W = cfg.ssm.head_dim, m.in_proj.weight
    dt0 = d_in + conv_dim
    return (F.linear(x, W[h0 * P:h1 * P]), F.linear(x, W[d_in:dt0]),
            F.linear(x, W[dt0 + h0:dt0 + h1]))


def _check_cache(cache: dict, cfg, batch: int) -> None:
    """``sharding.shd`` of a layer's cache block: the conv state whole but
    for its rows, the SSM state this process's heads (``state_heads``)."""
    s = cfg.ssm
    _, H, conv_dim = _dims(cfg)
    sharding.shd(cache["conv"], *CACHE_AXES["conv"], shape=(batch, s.conv_kernel - 1, conv_dim))
    sharding.shd(cache["ssm"], *CACHE_AXES["ssm"], shape=(batch, H, s.d_state, s.head_dim))


def fwd(m: Mamba2, cfg, x, *, mode, cache=None, batch: int | None = None,
        seq_axis: str | None = None, seq_group=None, use_kernel: str = "auto"):
    """x: (B, T, d).  Returns (out, new_cache).

    seq_axis: x is this process's shard of a sequence sharded over the
    processes of the default group (context parallelism): the conv takes
    its K-1 token halo from the left neighbour and the SSD scan its
    entering state from the ranks before (``distributed.seqpar``).

    cache (decode): {"conv": (B, K-1, conv_dim), "ssm": (B, H, N, P)}: the
    conv cache holds the pre-activation ``xBC`` of the last K-1 tokens, the
    SSM cache the state in x's dtype (read back in float32).

    Under sharding rules, serving (prefill, decode): x is this process's
    rows and ``batch`` the global batch; the SSM state is the local heads'
    and the conv state whole (:func:`_serving_in_proj`).  ``seq_group``:
    the tokens' subgroup under sequence parallelism (prefill), over which
    the output is reduce-scattered (``layers.row_join``)."""
    s = cfg.ssm
    B, T, d = x.shape
    rules = sharding.current()
    serving = rules is not None and mode != "train"
    tp = tp_group(cfg, rules)
    if tp is not None:   # this process's heads; the input's gradient summed over tp
        x = comm.copy_to(x, tp)
    proj, conv, conv_w, conv_b, A_log, D, dt_bias, norm_w, (d_in, H, G) = _local(m, cfg, tp)
    N, P = s.d_state, s.head_dim
    conv_dim = d_in + 2 * G * N

    if serving and tp is not None:   # xBC_all: every channel, for the conv state
        z, xBC_all, dt = _serving_in_proj(m, cfg, x, tp)
        xBC = xBC_all.index_select(-1, conv)
    else:
        w_in = m.in_proj.weight if proj is None else m.in_proj.weight[proj]
        z, xBC, dt = F.linear(x, w_in).split((d_in, conv_dim, H), dim=-1)
        xBC_all, conv = xBC, None
    A = -torch.exp(A_log.float())
    if serving and cache is not None:
        _check_cache(cache, cfg, batch)

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        conv_st = cache["conv"]  # (B, K-1, conv_dim), every channel
        window = torch.cat([conv_st, xBC_all], dim=1)  # (B, K, conv_dim)
        mine = window if conv is None else window.index_select(-1, conv)
        # window[k]: oldest..current; the conv applies w[j] to x[t-j], so
        # the current token takes w[0] -> flip w along taps
        xBC_t = torch.einsum("bkc,kc->bc", mine, conv_w.flip(0)) + conv_b
        xBC_t = F.silu(xBC_t)
        new_conv = window[:, 1:]
        xs = xBC_t[..., :d_in].reshape(B, H, P)
        Bs = xBC_t[..., d_in : d_in + G * N].reshape(B, G, N)
        Cs = xBC_t[..., d_in + G * N :].reshape(B, G, N)
        dt_t = F.softplus(dt[:, 0].float() + dt_bias)
        y, h_new = ssd_decode_step(cache["ssm"].float(), xs.float(), dt_t, A, Bs, Cs)
        y = y + D[None, :, None] * xs
        y = y.reshape(B, 1, d_in).to(x.dtype)
        new_cache = dict(cache, conv=new_conv, ssm=h_new.to(cache["ssm"].dtype))
    else:
        xBC_c = seq_conv1d_causal(xBC, conv_w, axis_name=seq_axis)
        xBC_c = F.silu(xBC_c + conv_b)
        xs = xBC_c[..., :d_in].reshape(B, T, H, P)
        Bs = xBC_c[..., d_in : d_in + G * N].reshape(B, T, G, N)
        Cs = xBC_c[..., d_in + G * N :].reshape(B, T, G, N)
        dtp = F.softplus(dt.float() + dt_bias)
        if seq_axis is not None:   # the states' halo: a doubling scan across the shards
            y, h_fin = seq_ssd_scan(xs, dtp, A, Bs, Cs, chunk=s.chunk, axis_name=seq_axis,
                                    use_kernel=use_kernel)
        else:
            y, h_fin = ssd_scan(xs, dtp, A, Bs, Cs, chunk=min(s.chunk, T),
                                use_kernel=use_kernel)
        y = y + D[None, None, :, None] * xs
        y = y.reshape(B, T, d_in)
        new_cache = None
        if mode == "prefill":
            K = s.conv_kernel
            pad = xBC_all.new_zeros(B, max(0, K - 1 - T), xBC_all.shape[-1])
            # the conv state holds the PRE-activation stream (post in_proj)
            new_cache = {
                "conv": torch.cat([pad, xBC_all[:, -(K - 1):]], dim=1),
                "ssm": h_fin.to(x.dtype),
            }
            if serving:
                _check_cache(new_cache, cfg, batch)

    # the gated norm's mean square over the whole d_inner: summed over tp
    y = rms_norm(y * F.silu(z), norm_w, cfg.norm_eps, over=tp)
    out = F.linear(y, m.out_proj.weight)
    # out_proj is row-parallel: the partial outputs summed
    return row_join(out, tp, seq_group), new_cache


def init_cache_specs(cfg, batch: int, dtype) -> dict:
    """The decode cache's shapes and dtype, as meta tensors (no memory)."""
    s = cfg.ssm
    d_in, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.empty((batch, s.conv_kernel - 1, conv_dim), dtype=dtype, device="meta"),
        "ssm": torch.empty((batch, H, s.d_state, s.head_dim), dtype=dtype, device="meta"),
    }
