"""Residual blocks: pre-norm (mixer | ffn) wiring per Layer spec.

The port's twin of the JAX package's ``models/blocks.py`` for the layers it
runs: a mixer, either a Mamba block or causal self-attention, global
(``"attn"``) or sliding-window (``"swa"``), then, where the layer has one,
an FFN behind its own pre-norm ``ln2``: an MoE FFN (``layer.moe``, which
takes precedence over ``layer.ffn``, as in the reference) or a dense one
(gated ``swiglu``/``geglu`` or a plain activation).  Cross-attention comes
with the rest of the LM scaffolding (ROADMAP.md, Queue A item 6) and raises
until then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import attention
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import act_fn, glu, rms_norm
from .params import ParamSpec

LATER = "ROADMAP.md, Queue A item 6 (cross-attention)"
GATED = ("swiglu", "geglu")


def check_layer(layer) -> None:
    """Raise on a layer the port does not implement yet."""
    if layer.mixer not in ("attn", "swa", "mamba") or layer.cross:
        raise NotImplementedError(
            f"mixer={layer.mixer!r}, cross={layer.cross}: not in the port yet ({LATER})")


def has_ffn(layer) -> bool:
    """An MoE or a dense FFN follows the mixer (behind ``ln2``)."""
    return layer.moe or layer.ffn


def _norm_spec(cfg) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), "zeros" if cfg.gemma_norm else "ones")


def ffn_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in GATED:
        return {"wi": ParamSpec((d, 2, f), ("fsdp", None, "ffn")),
                "wo": ParamSpec((f, d), ("ffn", "fsdp"))}
    return {"wi": ParamSpec((d, f), ("fsdp", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "fsdp"))}


class FFN(nn.Module):
    """``wi`` and ``wo`` as ``nn.Linear``: the reference's gated ``(d, 2, f)``
    leaf flattened to ``(d, 2f)`` (gate rows first, then up) and
    transposed; its ``(f, d)`` leaf transposed."""

    def __init__(self, cfg):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        meta = {"device": "meta", "bias": False}
        self.wi = nn.Linear(d, 2 * f if cfg.act in GATED else f, **meta)
        self.wo = nn.Linear(f, d, **meta)


def ffn_fwd(ffn: FFN, cfg, x):
    h = F.linear(x, ffn.wi.weight)
    if cfg.act in GATED:
        h = glu(h.unflatten(-1, (2, cfg.d_ff)), cfg.act)
    else:
        h = act_fn(cfg.act)(h)
    return F.linear(h, ffn.wo.weight)


def layer_specs(cfg, layer) -> dict:
    check_layer(layer)
    out = {"ln1": _norm_spec(cfg)}
    if layer.mixer == "mamba":
        out["mixer"] = ssm_mod.specs(cfg)
    else:
        out["mixer"] = attention.specs(cfg, layer)
    if has_ffn(layer):
        out["ln2"] = _norm_spec(cfg)
        out["ffn"] = moe_mod.specs(cfg) if layer.moe else ffn_specs(cfg)
    return out


class Block(nn.Module):
    """One layer's parameters: ``ln1``, the mixer and, where the layer has
    an FFN, ``ln2`` and the FFN, dense or MoE (meta until loaded)."""

    def __init__(self, cfg, layer):
        super().__init__()
        check_layer(layer)
        meta = {"device": "meta"}
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, **meta), requires_grad=False)
        if layer.mixer == "mamba":
            self.mixer = ssm_mod.Mamba2(cfg)
        else:
            self.mixer = attention.Attention(cfg, layer)
        if has_ffn(layer):
            self.ln2 = nn.Parameter(torch.empty(cfg.d_model, **meta), requires_grad=False)
            self.ffn = moe_mod.MoE(cfg) if layer.moe else FFN(cfg)

    def forward(self, x, *, cfg, layer, positions, seq_axis=None, use_kernel: str = "auto"):
        """The layer in train mode: (x, aux), what a checkpointed layer of
        training returns."""
        x, _, aux = layer_fwd(self, cfg, layer, x, mode="train", positions=positions,
                              seq_axis=seq_axis, use_kernel=use_kernel)
        return x, aux


def layer_fwd(block: Block, cfg, layer, x, *, mode, positions=None, cache=None,
              cache_len=None, seq_axis=None, use_kernel: str = "auto"):
    """Returns (x, new_cache, aux).  ``seq_axis``: x is this process's
    shard of a sequence sharded over the default group (context
    parallelism); the mixers exchange their halos, the FFN (dense, or MoE
    at the shard's capacity, as the reference's) is local."""
    aux = x.new_zeros((), dtype=torch.float32)
    if cache is not None:
        new_cache = dict(cache)
    elif mode == "prefill":
        new_cache = {}  # prefill CREATES the cache
    else:
        new_cache = None

    def norm(h, w):
        return rms_norm(h, w, cfg.norm_eps, scale_plus_one=cfg.gemma_norm)

    mixer_cache = cache.get("mixer") if cache is not None else None
    if layer.mixer == "mamba":
        h, c = ssm_mod.fwd(block.mixer, cfg, norm(x, block.ln1), mode=mode, cache=mixer_cache,
                           seq_axis=seq_axis, use_kernel=use_kernel)
    else:
        h, c = attention.fwd(block.mixer, cfg, layer, norm(x, block.ln1), mode=mode,
                             positions=positions, cache=mixer_cache, cache_len=cache_len,
                             seq_axis=seq_axis, use_kernel=use_kernel)
    x = x + h
    if new_cache is not None and c is not None:
        new_cache["mixer"] = c
    if has_ffn(layer):
        h = norm(x, block.ln2)
        if layer.moe:
            h, a = moe_mod.fwd(block.ffn, cfg, h)
            aux = aux + a
        else:
            h = ffn_fwd(block.ffn, cfg, h)
        x = x + h
    return x, new_cache, aux


def layer_cache_specs(cfg, layer, batch: int, cache_len: int, dtype) -> dict:
    check_layer(layer)
    if layer.mixer == "mamba":
        return {"mixer": ssm_mod.init_cache_specs(cfg, batch, dtype)}
    return {"mixer": attention.init_cache_specs(cfg, layer, batch, cache_len, dtype)}
