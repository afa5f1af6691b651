"""Residual blocks: pre-norm (mixer | ffn) wiring per Layer spec.

The port's twin of the JAX package's ``models/blocks.py`` for the layers it
runs: a mixer, either a Mamba block or causal self-attention, global
(``"attn"``) or sliding-window (``"swa"``), then, where the layer has one,
an FFN behind its own pre-norm ``ln2``: an MoE FFN (``layer.moe``, which
takes precedence over ``layer.ffn``, as in the reference) or a dense one
(gated ``swiglu``/``geglu`` or a plain activation).  Cross-attention comes
with the rest of the LM scaffolding (ROADMAP.md, Queue A item 6) and raises
until then.

Under installed sharding rules a dense FFN is tensor-parallel over the
mesh axes of ``ffn`` (Megatron-LM's split): ``wi`` column-parallel (this
process's ``d_ff / tp`` columns of the gate and of the up projection),
``wo`` row-parallel, its partial outputs summed over those processes
(``comm.sum_over``), its input through ``comm.copy_to``.  A Mamba layer is
tensor-parallel over its heads (``ssm.tp_group``) and an MoE FFN
expert-parallel (``moe.ep_group``).  :func:`check_sharded` raises, before
any collective, on a layer whose shapes do not split over the mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import comm
from ..distributed import sharding
from . import attention
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import act_fn, glu, rms_norm, row_join
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


def ffn_tp_axes(cfg, rules) -> tuple:
    """The mesh axes a dense FFN's ``d_ff`` is split over under ``rules``
    (() without rules); raises where ``d_ff`` does not split over every
    axis of the ``ffn`` rule."""
    if rules is None:
        return ()
    sp = ffn_specs(cfg)["wi"]
    return sharding.split_axes(rules, sp.axes, sp.shape, -1, f"d_ff {cfg.d_ff} does not split")


def ffn_tp_group(cfg, rules):
    """The subgroup of :func:`ffn_tp_axes` (None: no rules, or one process)."""
    return sharding.subgroup(rules, ffn_tp_axes(cfg, rules))


def ffn_fwd(ffn: FFN, cfg, x, seq_group=None):
    tp = ffn_tp_group(cfg, sharding.current())
    if tp is not None:
        x = comm.copy_to(x, tp)
    h = F.linear(x, ffn.wi.weight)
    if cfg.act in GATED:
        h = glu(h.unflatten(-1, (2, -1)), cfg.act)
    else:
        h = act_fn(cfg.act)(h)
    return row_join(F.linear(h, ffn.wo.weight), tp, seq_group)


def check_sharded(cfg, layer, rules, *, batch: int | None = None, prompt: int | None = None,
                  cache_len: int | None = None) -> None:
    """Raise, naming the shapes and the mesh, where a shape of ``layer``
    that ``rules`` split does not split over the mesh: its mixer's heads
    (attention, Mamba) and its FFN's ``d_ff`` or experts.  Serving
    (``batch``, the global batch; ``prompt``, ``cache_len``): also where
    the rules would split the caches' rows otherwise than the batch's (a
    process would hold rows it does not compute), or where a prompt is
    longer than an attention layer's cache.  Reads the rules only (no
    subgroup is made), so it may run before any collective."""
    if rules is None:
        return
    if layer.mixer == "mamba":
        ssm_mod.tp_axes(cfg, rules)
    else:
        attention.tp_axes(cfg, layer, rules)
    if layer.moe:
        moe_mod.ep_axes(cfg, rules)
    elif layer.ffn:
        ffn_tp_axes(cfg, rules)
    if batch is None:
        return
    mesh = rules.mesh
    if layer.mixer != "mamba" and prompt is not None and prompt > cache_len:
        raise NotImplementedError(
            f"a prompt of {prompt} tokens is longer than the caches' {cache_len} slots: "
            f"under sharding rules the caches are split at cache_len ({dict(mesh.shape)})")
    rows = sharding.entry_axes(rules.spec("batch", None, shape=(batch, 1))[0])
    for name, t in layer_cache_specs(cfg, layer, batch, cache_len or 1,
                                     torch.float32)["mixer"].items():
        axes = CACHE_AXES[name][:t.ndim]
        got = sharding.entry_axes(rules.spec(*axes, shape=tuple(t.shape))[0])
        if got != rows:
            raise NotImplementedError(
                f"a batch of {batch} rows splits over the mesh axes {rows}, the rows of the "
                f"cache leaf {name!r} {tuple(t.shape)} over {got} ({dict(mesh.shape)})")


# the logical axes of every cache leaf (the reference's cache_axes)
CACHE_AXES = {**attention.CACHE_AXES, **ssm_mod.CACHE_AXES}


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
              cache_len=None, batch=None, seq_axis=None, seq_group=None,
              use_kernel: str = "auto"):
    """Returns (x, new_cache, aux).  ``seq_axis``: x is this process's
    shard of a sequence sharded over the default group (context
    parallelism); the mixers exchange their halos, the FFN (dense, or MoE
    at the shard's capacity, as the reference's) is local.

    ``seq_group``: sequence parallelism under sharding rules (prefill): x
    is this process's block of the tokens (B, T / k, d); the normed input
    of the mixer and of the FFN is gathered over the subgroup
    (``comm.gather_over``), so that they see every token (the MoE's
    capacity is the reference's), and their row-parallel outputs are
    reduce-scattered back (``layers.row_join``).  ``batch``,
    ``cache_len``: the global batch and cache length of serving under
    rules."""
    aux = x.new_zeros((), dtype=torch.float32)
    if cache is not None:
        new_cache = dict(cache)
    elif mode == "prefill":
        new_cache = {}  # prefill CREATES the cache
    else:
        new_cache = None

    def norm(h, w):   # every token's, under sequence parallelism
        h = rms_norm(h, w, cfg.norm_eps, scale_plus_one=cfg.gemma_norm)
        return h if seq_group is None else comm.gather_over(h, seq_group, 1)

    mixer_cache = cache.get("mixer") if cache is not None else None
    if layer.mixer == "mamba":
        h, c = ssm_mod.fwd(block.mixer, cfg, norm(x, block.ln1), mode=mode, cache=mixer_cache,
                           batch=batch, seq_axis=seq_axis, seq_group=seq_group,
                           use_kernel=use_kernel)
    else:
        h, c = attention.fwd(block.mixer, cfg, layer, norm(x, block.ln1), mode=mode,
                             positions=positions, cache=mixer_cache, cache_len=cache_len,
                             batch=batch, seq_axis=seq_axis, seq_group=seq_group,
                             use_kernel=use_kernel)
    x = x + h
    if new_cache is not None and c is not None:
        new_cache["mixer"] = c
    if has_ffn(layer):
        h = norm(x, block.ln2)
        if layer.moe:
            h, a = moe_mod.fwd(block.ffn, cfg, h, seq_group)
            aux = aux + a
        else:
            h = ffn_fwd(block.ffn, cfg, h, seq_group)
        x = x + h
    return x, new_cache, aux


def layer_cache_specs(cfg, layer, batch: int, cache_len: int, dtype) -> dict:
    check_layer(layer)
    if layer.mixer == "mamba":
        return {"mixer": ssm_mod.init_cache_specs(cfg, batch, dtype)}
    return {"mixer": attention.init_cache_specs(cfg, layer, batch, cache_len, dtype)}
