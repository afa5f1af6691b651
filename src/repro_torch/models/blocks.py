"""Residual blocks: pre-norm mixer wiring per Layer spec.

The port's twin of the JAX package's ``models/blocks.py`` for the layers it
runs: a Mamba mixer with no FFN (``Layer(mixer="mamba", ffn=False)``).
Attention mixers, cross-attention, MoE and dense FFNs come with the rest
of the LM scaffolding (ROADMAP.md, Queue A item 6) and raise until then.
"""

from __future__ import annotations

import torch
from torch import nn

from . import ssm as ssm_mod
from .layers import rms_norm
from .params import ParamSpec

LATER = "ROADMAP.md, Queue A item 6 (attention, MoE and dense FFN layers)"


def check_layer(layer) -> None:
    """Raise on a layer the port does not implement yet."""
    if layer.mixer != "mamba":
        raise NotImplementedError(f"mixer {layer.mixer!r}: not in the port yet ({LATER})")
    if layer.cross or layer.moe or layer.ffn:
        raise NotImplementedError(
            f"cross={layer.cross}, moe={layer.moe}, ffn={layer.ffn}: not in the port yet ({LATER})")


def layer_specs(cfg, layer) -> dict:
    check_layer(layer)
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), (None,), "zeros" if cfg.gemma_norm else "ones"),
            "mixer": ssm_mod.specs(cfg)}


class Block(nn.Module):
    """One layer's parameters: ``ln1`` and the mixer (meta until loaded)."""

    def __init__(self, cfg, layer):
        super().__init__()
        check_layer(layer)
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, device="meta"), requires_grad=False)
        self.mixer = ssm_mod.Mamba2(cfg)


def layer_fwd(block: Block, cfg, layer, x, *, mode, positions=None, cache=None,
              use_kernel: str = "auto"):
    """Returns (x, new_cache, aux)."""
    aux = x.new_zeros((), dtype=torch.float32)
    if cache is not None:
        new_cache = dict(cache)
    elif mode == "prefill":
        new_cache = {}  # prefill CREATES the cache
    else:
        new_cache = None
    h, c = ssm_mod.fwd(block.mixer, cfg,
                       rms_norm(x, block.ln1, cfg.norm_eps, scale_plus_one=cfg.gemma_norm),
                       mode=mode, cache=cache.get("mixer") if cache is not None else None,
                       use_kernel=use_kernel)
    x = x + h
    if new_cache is not None and c is not None:
        new_cache["mixer"] = c
    return x, new_cache, aux


def layer_cache_specs(cfg, layer, batch: int, cache_len: int, dtype) -> dict:
    check_layer(layer)
    return {"mixer": ssm_mod.init_cache_specs(cfg, batch, dtype)}
