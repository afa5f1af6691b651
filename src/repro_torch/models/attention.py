"""GQA self-attention, global and sliding-window: train, prefill, decode.

The port's twin of the JAX package's ``models/attention.py`` for causal
self-attention.  Train and prefill go through K6's dispatch point
(:func:`repro_torch.kernels.swa.swa_attention`): the CUDA kernel on the
card, ``swa_ref`` on the CPU.  A window layer passes ``layer.window``, a
global layer ``window = S``, which ``swa_ref`` defines as plain causal
attention.  The reference computes the same function with the jnp
``_attend`` under a band mask, or ``_attend_swa`` for long sequences.
Decode is the plain :func:`_attend` over the cache, with the reference's
ring-buffer slots and masks.  Under ``cfg.kv_quant`` the cache holds int8
keys and values with one float32 scale per (token, kv head)
(:func:`_kv_quantize`), dequantised before :func:`_attend`.

Under ``seq_axis`` (context parallelism, train mode only) x is this
process's shard of a sequence sharded over the processes of the default
group: a window layer runs :func:`repro_torch.distributed.seqpar.
seq_sliding_window_attention` (K6 over a kv halo), a global layer
:func:`repro_torch.distributed.ring.ring_attention`.

Under installed sharding rules (:mod:`repro_torch.distributed.sharding`;
train mode, ``transformer.fwd`` raises on the others) the layer is tensor-parallel over the mesh axes of ``heads``,
as Megatron-LM splits it: the weights arrive with their ``fsdp``
dimensions gathered (``transformer``), ``wq`` holding this process's
``H / tp`` query heads and ``wo`` their rows; ``wk``/``wv`` are whole
(``kv_heads`` is not sharded) and the process slices the kv heads its query
heads use.  The input passes through ``comm.copy_to`` (its gradient is
summed over the heads' processes) and ``wo``'s partial outputs through
``comm.sum_over``.  K6 runs on the local heads, forward and backward.

Cross-attention, non-causal layers and a soft cap on the kernel path
raise: they come with the rest of the LM scaffolding (ROADMAP.md, Queue A
item 6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import comm
from ..distributed import sharding
from ..distributed.ring import ring_attention
from ..distributed.seqpar import seq_sliding_window_attention
from ..kernels.swa import swa_attention
from .layers import rms_norm, rope, softcap
from .params import ParamSpec

LATER = "ROADMAP.md, Queue A item 6"
NEG_INF = -1e30
# the layer's weights whose gradient a tensor-parallel process holds only in
# part (its query heads' share): summed over the heads' processes
TP_PARTIAL = ("wk.weight", "wv.weight", "q_norm", "k_norm")


def specs(cfg, layer) -> dict:
    check_layer(cfg, layer)
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    out = {
        "wq": ParamSpec((d, H, Dh), ("fsdp", "heads", None)),
        "wk": ParamSpec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "wv": ParamSpec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "wo": ParamSpec((H, Dh, d), ("heads", None, "fsdp")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((Dh,), (None,), "ones")
        out["k_norm"] = ParamSpec((Dh,), (None,), "ones")
    return out


def check_layer(cfg, layer) -> None:
    """Raise on what the port's attention does not implement yet."""
    for what, unsupported in (("cross-attention", layer.cross),
                              ("a non-causal layer", not layer.causal)):
        if unsupported:
            raise NotImplementedError(f"{what}: not in the port yet ({LATER})")


class Attention(nn.Module):
    """The projections as ``nn.Linear`` (weight ``(out, in)``: ``wq`` is
    the reference's ``(d, H, Dh)`` leaf flattened to ``(d, H*Dh)`` and
    transposed, ``wo`` its ``(H, Dh, d)`` leaf flattened to ``(H*Dh, d)``
    and transposed); ``q_norm``/``k_norm`` as they are.  Built on the meta
    device; the model assigns the real tensors."""

    def __init__(self, cfg, layer):
        super().__init__()
        check_layer(cfg, layer)
        d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        meta = {"device": "meta", "bias": False}
        self.wq = nn.Linear(d, H * Dh, **meta)
        self.wk = nn.Linear(d, Hkv * Dh, **meta)
        self.wv = nn.Linear(d, Hkv * Dh, **meta)
        self.wo = nn.Linear(H * Dh, d, **meta)
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(Dh, device="meta"), requires_grad=False))


def tp_axes(cfg, layer, rules) -> tuple:
    """The mesh axes the layer's query heads are split over under ``rules``
    (() without rules).  The rules must split the heads over all of the
    ``heads`` rule's axes (else the layer would run replicated on them,
    which the gradient sums do not allow): otherwise, and where a
    process's query heads do not map onto whole kv heads, it raises."""
    if rules is None:
        return ()
    mesh, sp = rules.mesh, specs(cfg, layer)["wq"]
    axes = sharding.split_axes(rules, sp.axes, sp.shape, 1,
                               f"{cfg.n_heads} query heads do not split")
    Hl, g = cfg.n_heads // math.prod(mesh.shape[a] for a in axes), cfg.n_heads // cfg.n_kv
    if Hl % g and g % Hl:
        raise NotImplementedError(
            f"{Hl} query heads a process do not map onto whole kv heads (group of {g})")
    return axes


def tp_group(cfg, layer, rules):
    """The subgroup of :func:`tp_axes` (None: no rules, or one process)."""
    return sharding.subgroup(rules, tp_axes(cfg, layer, rules))


def _local_kv(w, cfg, sub, Hl: int):
    """The rows of a whole ``wk``/``wv`` weight ``(Hkv Dh, d)`` for the kv
    heads that this process's query heads ``[i Hl, (i + 1) Hl)`` use."""
    g, Dh = cfg.n_heads // cfg.n_kv, cfg.head_dim
    q0 = sub.index * Hl
    k0, k1 = q0 // g, (q0 + Hl - 1) // g + 1
    return w[k0 * Dh:k1 * Dh]


def _kv_quantize(kv):
    """Per (token, head) int8 quantization over head_dim.

    kv: (B, S, Hkv, Dh) -> (int8 kv, float32 scale (B, S, Hkv)): the scale
    is max |kv| / 127 (1 where that is 0), the values rounded half to even,
    as ``jnp.round`` does."""
    kf = kv.float()
    s = kf.abs().amax(dim=-1) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.round(kf / s[..., None]).to(torch.int8), s


def _kv_dequantize(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def _expand_kv(kv, H):
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating each kv head g times."""
    return torch.repeat_interleave(kv, H // kv.shape[2], dim=2)


def _attend(q, kh, vh, mask, *, attn_softcap=0.0):
    """The plain attention of decode.  q: (B,T,H,D); kh/vh: (B,S,H,D);
    mask: (T,S) bool."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q * scale, kh).float()
    if attn_softcap:
        logits = softcap(logits, attn_softcap)
    logits = torch.where(mask, logits, logits.new_full((), NEG_INF))
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", p, vh)


def _ring(kv, S_c: int, last):
    """The last ``S_c`` tokens of ``kv`` (B, T, Hkv, D) laid out as the
    reference's ring buffer: ``roll`` by ``(last + 1) % S_c`` along time,
    as a gather so that ``last`` (a 0-d tensor) stays on the device."""
    idx = torch.remainder(torch.arange(S_c, device=kv.device) - (last + 1), S_c)
    return kv[:, -S_c:].index_select(1, idx)


def fwd(attn: Attention, cfg, layer, x, *, mode, positions, cache=None, cache_len=None,
        seq_axis: str | None = None, use_kernel: str = "auto"):
    """Returns (out, new_cache).

    mode: train | prefill | decode.  positions: (T,) absolute positions of
    the x tokens (decode: (1,) the current position), a tensor on x's
    device.  cache (decode): {"k", "v": (B, S_cache, Hkv, Dh)}; prefill
    creates it at ``cache_len`` (default T).  Decode returns new cache
    tensors and leaves the given ones as they are."""
    check_layer(cfg, layer)
    if seq_axis is not None and mode != "train":
        raise ValueError(f"seq_axis (context parallelism) runs train mode only, got {mode!r}")
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    tp = tp_group(cfg, layer, sharding.current())
    wk, wv = attn.wk.weight, attn.wv.weight
    if tp is not None:   # this process's query heads and the kv heads they use
        x = comm.copy_to(x, tp)
        H = H // tp.size
        wk, wv = _local_kv(wk, cfg, tp, H), _local_kv(wv, cfg, tp, H)
        Hkv = wk.shape[0] // Dh
    q = F.linear(x, attn.wq.weight).view(B, T, H, Dh)
    k = F.linear(x, wk).view(B, T, Hkv, Dh)
    v = F.linear(x, wv).view(B, T, Hkv, Dh)
    if cfg.qk_norm:  # no (1 + w) here, even under gemma_norm, as in the reference
        q = rms_norm(q, attn.q_norm, cfg.norm_eps)
        k = rms_norm(k, attn.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)  # the cache stores post-RoPE keys

    window = layer.window if layer.mixer == "swa" else 0

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        S = cache["k"].shape[1]
        pos = positions[0]
        slot = torch.remainder(pos, S) if window else torch.clamp(pos, max=S - 1)
        slot = slot.reshape(1)
        if cfg.kv_quant:
            (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
            knew, vnew = cache["k"].index_copy(1, slot, kq), cache["v"].index_copy(1, slot, vq)
            ksn = cache["k_s"].index_copy(1, slot, ks)
            vsn = cache["v_s"].index_copy(1, slot, vs)
            new_cache = dict(cache, k=knew, v=vnew, k_s=ksn, v_s=vsn)
            kf, vf = _kv_dequantize(knew, ksn, k.dtype), _kv_dequantize(vnew, vsn, v.dtype)
        else:
            knew = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
            vnew = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
            new_cache = dict(cache, k=knew, v=vnew)
            kf, vf = knew, vnew
        sl = torch.arange(S, device=x.device)
        valid = (sl <= pos) | (pos >= S) if window else sl <= pos  # a full ring: every slot
        out = _attend(q, _expand_kv(kf, H), _expand_kv(vf, H), valid[None, :],
                      attn_softcap=cfg.attn_softcap)
    elif seq_axis is not None:
        # context parallelism: the sequence is sharded over the group's
        # processes and x is this process's shard at absolute ``positions``;
        # a window layer takes a kv halo from the left neighbour (the
        # paper's halo update on the token grid), a global layer runs ring
        # attention (an iterated halo)
        if cfg.attn_softcap:
            raise NotImplementedError(f"attn_softcap on the kernel path: not in the port yet "
                                      f"({LATER})")
        qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window:
            oT = seq_sliding_window_attention(qT, kT, vT, window=window, axis_name=seq_axis,
                                              use_kernel=use_kernel)
        else:
            oT = ring_attention(qT, kT, vT, axis_name=seq_axis, use_kernel=use_kernel)
        out = oT.transpose(1, 2)
        new_cache = None
    else:  # train / prefill: K6's dispatch point, window = T for a global layer
        if cfg.attn_softcap:
            raise NotImplementedError(f"attn_softcap on the kernel path: not in the port yet "
                                      f"({LATER})")
        out = swa_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            window=window or T, use_kernel=use_kernel).transpose(1, 2)
        new_cache = None
        if mode == "prefill":
            S_target = cache_len if cache_len is not None else T
            if window:
                S_c = min(window, S_target)
                if T >= S_c:  # keep the last S_c tokens, laid out ring-buffer style
                    ks, vs = _ring(k, S_c, positions[-1]), _ring(v, S_c, positions[-1])
                else:
                    ks = F.pad(k, (0, 0, 0, 0, 0, S_c - T))
                    vs = F.pad(v, (0, 0, 0, 0, 0, S_c - T))
            else:
                pad = max(0, S_target - T)
                ks = F.pad(k, (0, 0, 0, 0, 0, pad))
                vs = F.pad(v, (0, 0, 0, 0, 0, pad))
            if cfg.kv_quant:
                (kq, kss), (vq, vss) = _kv_quantize(ks), _kv_quantize(vs)
                new_cache = {"k": kq, "v": vq, "k_s": kss, "v_s": vss}
            else:
                new_cache = {"k": ks, "v": vs}

    out = F.linear(out.reshape(B, T, H * Dh), attn.wo.weight)
    if tp is not None:   # wo is row-parallel: the processes' partial outputs summed
        out = comm.sum_over(out, tp)
    return out, new_cache


def cache_len_hint(cfg, layer) -> int:
    return layer.window if (layer.mixer == "swa" and layer.window) else cfg.max_seq


def init_cache_specs(cfg, layer, batch: int, cache_len: int, dtype) -> dict:
    """The decode cache's shapes and dtype, as meta tensors (no memory)."""
    check_layer(cfg, layer)
    Hkv, Dh = cfg.n_kv, cfg.head_dim
    S = min(layer.window, cache_len) if (layer.mixer == "swa" and layer.window) else cache_len
    if cfg.kv_quant:
        kv = torch.empty((batch, S, Hkv, Dh), dtype=torch.int8, device="meta")
        sc = torch.empty((batch, S, Hkv), dtype=torch.float32, device="meta")
        return {"k": kv, "v": kv.clone(), "k_s": sc, "v_s": sc.clone()}
    return {"k": torch.empty((batch, S, Hkv, Dh), dtype=dtype, device="meta"),
            "v": torch.empty((batch, S, Hkv, Dh), dtype=dtype, device="meta")}
