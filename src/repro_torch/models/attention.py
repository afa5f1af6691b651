"""GQA self-attention, global and sliding-window: train, prefill, decode.

The port's twin of the JAX package's ``models/attention.py`` for causal
self-attention.  Train and prefill go through K6's dispatch point
(:func:`repro_torch.kernels.swa.swa_attention`): the CUDA kernel on the
card, ``swa_ref`` on the CPU.  A window layer passes ``layer.window``, a
global layer ``window = S``, which ``swa_ref`` defines as plain causal
attention.  The reference computes the same function with the jnp
``_attend`` under a band mask, or ``_attend_swa`` for long sequences.
Decode is plain attention over the cache (:func:`_decode`), with the
reference's ring-buffer slots and masks, as a log-sum-exp combine of
partial softmaxes (flash-decoding, one partial in one process).  Under
``cfg.kv_quant`` the cache holds int8 keys and values with one float32
scale per (token, kv head) (:func:`_kv_quantize`), dequantised before
the attention.

Under ``seq_axis`` (context parallelism, train mode only) x is this
process's shard of a sequence sharded over the processes of the default
group: a window layer runs :func:`repro_torch.distributed.seqpar.
seq_sliding_window_attention` (K6 over a kv halo), a global layer
:func:`repro_torch.distributed.ring.ring_attention`.

Under installed sharding rules (:mod:`repro_torch.distributed.sharding`)
the layer is tensor-parallel over the mesh axes of ``heads``, as
Megatron-LM splits it: the weights arrive with their ``fsdp`` dimensions
gathered (``transformer``), ``wq`` holding this process's ``H / tp`` query
heads and ``wo`` their rows; ``wk``/``wv`` are whole (``kv_heads`` is not
sharded).  In training the process slices the kv heads its query heads
use; the input passes through ``comm.copy_to`` (its gradient is summed
over the heads' processes) and ``wo``'s partial outputs through
``comm.sum_over``.  K6 runs on the local heads, forward and backward.

Serving under rules (prefill and decode) computes k/v for every kv head,
since the cache holds them all, and keeps this process's block of the
cache: its rows of ``cache_batch`` and its slots of ``cache_seq``
(:func:`cache_slots`, the reference's ``cache_shardings``).  Prefill runs
K6 on the local heads.  Decode is flash-decoding: the owner of the new
token's slot writes it, q is gathered over the heads' processes, every
head's partial softmax is taken over the local slots and combined over
the cache's subgroup (``distributed.ring.lse_combine_decode_over``), and
the local heads go on to ``wo``.  Under sequence parallelism (prefill) the
output is reduce-scattered over the tokens (``layers.row_join``).

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
from ..distributed.ring import decode_valid, lse_combine_decode_over, ring_attention
from ..distributed.seqpar import seq_sliding_window_attention
from ..kernels.swa import swa_attention
from .layers import rms_norm, rope, row_join
from .params import ParamSpec

LATER = "ROADMAP.md, Queue A item 6"
# the logical axes of the cache's leaves (the reference's ``cache_axes``)
CACHE_AXES = {"k": ("cache_batch", "cache_seq", None, None),
              "v": ("cache_batch", "cache_seq", None, None),
              "k_s": ("cache_batch", "cache_seq", None), "v_s": ("cache_batch", "cache_seq", None)}
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


def _kv_range(cfg, sub, Hl: int) -> slice:
    """The kv heads that this process's query heads ``[i Hl, (i + 1) Hl)``
    use (``sub``: the heads' subgroup, ``i`` its index)."""
    g = cfg.n_heads // cfg.n_kv
    q0 = sub.index * Hl
    return slice(q0 // g, (q0 + Hl - 1) // g + 1)


def cache_slots(rules, cfg, batch: int, S: int):
    """This process's slots of a KV cache of ``S`` slots and ``batch`` rows
    under ``rules`` (the reference's ``cache_shardings``: ``cache_seq``
    over the mesh axes that ``fit`` keeps for ``S``): ``(offset, n, sub)``,
    the first global slot, the number of slots, and the subgroup that holds
    the other slots (None: this process holds them all)."""
    sp = rules.spec(*CACHE_AXES["k"], shape=(batch, S, cfg.n_kv, cfg.head_dim))[1]
    n = S // sharding.entry_size(rules.mesh, sp)
    return rules.mesh.index(sp) * n, n, sharding.subgroup(rules, sharding.entry_axes(sp))


def _check_cache(cache: dict, cfg, batch: int, S: int) -> None:
    """``sharding.shd`` of every leaf of a layer's cache block: the local
    shape the reference's ``cache_shardings`` gives."""
    for name, t in cache.items():
        sharding.shd(t, *CACHE_AXES[name], shape=(batch, S, cfg.n_kv, cfg.head_dim)[:t.ndim])


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


def _ring(kv, S_c: int, last):
    """The last ``S_c`` tokens of ``kv`` (B, T, Hkv, D) laid out as the
    reference's ring buffer: ``roll`` by ``(last + 1) % S_c`` along time,
    as a gather so that ``last`` (a 0-d tensor) stays on the device."""
    idx = torch.remainder(torch.arange(S_c, device=kv.device) - (last + 1), S_c)
    return kv[:, -S_c:].index_select(1, idx)


def fwd(attn: Attention, cfg, layer, x, *, mode, positions, cache=None, cache_len=None,
        batch: int | None = None, seq_axis: str | None = None, seq_group=None,
        use_kernel: str = "auto"):
    """Returns (out, new_cache).

    mode: train | prefill | decode.  positions: (T,) absolute positions of
    the x tokens (decode: (1,) the current position), a tensor on x's
    device.  cache (decode): {"k", "v": (B, S_cache, Hkv, Dh)}; prefill
    creates it at ``cache_len`` (default T).  Decode returns new cache
    tensors and leaves the given ones as they are.

    Under sharding rules, prefill and decode (serving): x is this
    process's rows, ``batch`` the global batch and ``cache_len`` the
    global cache length (decode too); the cache is this process's block
    (:func:`cache_slots`).  ``seq_group``: the tokens' subgroup under
    sequence parallelism, over which the output is reduce-scattered
    (``layers.row_join``)."""
    check_layer(cfg, layer)
    if seq_axis is not None and mode != "train":
        raise ValueError(f"seq_axis (context parallelism) runs train mode only, got {mode!r}")
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    rules = sharding.current()
    serving = rules is not None and mode != "train"
    tp = tp_group(cfg, layer, rules)
    kv = slice(0, Hkv)
    wk, wv = attn.wk.weight, attn.wv.weight
    if tp is not None:   # this process's query heads and the kv heads they use
        x = comm.copy_to(x, tp)
        H = H // tp.size
        kv = _kv_range(cfg, tp, H)
        if not serving:   # the serving cache holds every kv head: k/v of all of them
            wk, wv = wk[kv.start * Dh:kv.stop * Dh], wv[kv.start * Dh:kv.stop * Dh]
    q = F.linear(x, attn.wq.weight).view(B, T, H, Dh)
    k = F.linear(x, wk).view(B, T, -1, Dh)
    v = F.linear(x, wv).view(B, T, -1, Dh)
    if cfg.qk_norm:  # no (1 + w) here, even under gemma_norm, as in the reference
        q = rms_norm(q, attn.q_norm, cfg.norm_eps)
        k = rms_norm(k, attn.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)  # the cache stores post-RoPE keys
    kc, vc = k, v   # the cache's kv heads
    if serving:
        k, v = k[:, :, kv], v[:, :, kv]

    window = layer.window if layer.mixer == "swa" else 0

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        out, new_cache = _decode(q, kc, vc, cache, positions[0], cfg, window, tp, batch,
                                 cache_len)
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
                    ks, vs = _ring(kc, S_c, positions[-1]), _ring(vc, S_c, positions[-1])
                else:
                    ks = F.pad(kc, (0, 0, 0, 0, 0, S_c - T))
                    vs = F.pad(vc, (0, 0, 0, 0, 0, S_c - T))
            else:
                S_c = max(S_target, T)
                ks = F.pad(kc, (0, 0, 0, 0, 0, S_c - T))
                vs = F.pad(vc, (0, 0, 0, 0, 0, S_c - T))
            if serving:   # this process's block of the slots
                off, n, _ = cache_slots(rules, cfg, batch, S_c)
                ks, vs = ks[:, off:off + n], vs[:, off:off + n]
            if cfg.kv_quant:
                (kq, kss), (vq, vss) = _kv_quantize(ks), _kv_quantize(vs)
                new_cache = {"k": kq, "v": vq, "k_s": kss, "v_s": vss}
            else:
                new_cache = {"k": ks, "v": vs}
            if serving:
                _check_cache(new_cache, cfg, batch, S_c)

    out = F.linear(out.reshape(B, T, H * Dh), attn.wo.weight)
    # wo is row-parallel: the processes' partial outputs summed
    return row_join(out, tp, seq_group), new_cache


def _decode(q, k, v, cache, pos, cfg, window: int, tp, batch, cache_len):
    """One decode step against the cache, or under sharding rules against
    this process's block of a length-sharded cache (flash-decoding).  q:
    (B, 1, Hl, Dh), the (local) query heads; k/v: (B, 1, Hkv, Dh), the new
    token's, every kv head.  The holder of the token's slot (``pos % S`` in
    a window layer's ring, ``min(pos, S - 1)`` in a global layer's cache)
    writes it; q is gathered over the heads' processes, every head's
    partial softmax taken over the local slots (validity from their global
    indices) and combined over the cache's subgroup; the local heads are
    kept.  Returns (out (B, 1, Hl, Dh), new cache)."""
    rules = sharding.current()
    if rules is None:   # one process holds every slot
        S = n = cache["k"].shape[1]
        off, sub = 0, None
    else:
        S = min(window, cache_len) if window else cache_len
        off, n, sub = cache_slots(rules, cfg, batch, S)
        _check_cache(cache, cfg, batch, S)
    slots = off + torch.arange(n, device=q.device)
    slot = torch.remainder(pos, S) if window else torch.clamp(pos, max=S - 1)
    own = (slots == slot)[None, :, None, None]   # a where, not a host branch
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
        knew, vnew = torch.where(own, kq, cache["k"]), torch.where(own, vq, cache["v"])
        ksn = torch.where(own[..., 0], ks, cache["k_s"])
        vsn = torch.where(own[..., 0], vs, cache["v_s"])
        new_cache = dict(cache, k=knew, v=vnew, k_s=ksn, v_s=vsn)
        kf, vf = _kv_dequantize(knew, ksn, k.dtype), _kv_dequantize(vnew, vsn, v.dtype)
    else:
        knew = torch.where(own, k.to(cache["k"].dtype), cache["k"])
        vnew = torch.where(own, v.to(cache["v"].dtype), cache["v"])
        new_cache = dict(cache, k=knew, v=vnew)
        kf, vf = knew, vnew
    Hl = q.shape[2]
    qa = q[:, 0] if tp is None else comm.gather_over(q[:, 0], tp, dim=1)
    o = lse_combine_decode_over(qa, kf, vf, decode_valid(slots, pos, S, bool(window)), sub,
                                attn_softcap=cfg.attn_softcap)
    if tp is not None:
        o = o[:, tp.index * Hl:(tp.index + 1) * Hl]
    return o[:, None], new_cache


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
