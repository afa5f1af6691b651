"""Model and config dataclasses, and the registry of the configs the port
runs.

A copy of the JAX package's ``configs/base.py`` field for field: the port
imports nothing of that package.  ``ModelCfg.param_count`` counts from the
port's own :mod:`repro_torch.models`.  The registry holds only the configs
whose layers the port implements; asking for another raises a
``KeyError`` that names the slice that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden size
    n_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64         # P
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class Layer:
    """One (mixer, ffn) layer of a pattern."""

    mixer: str = "attn"        # attn | swa | mamba | none
    cross: bool = False        # insert a cross-attention sublayer
    moe: bool = False          # MoE FFN instead of dense
    window: int = 0            # sliding-window size for mixer == "swa"
    causal: bool = True        # False for encoder self-attention
    ffn: bool = True           # False: mixer-only layer (pure Mamba archs)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # ((pattern layers...), repeat) — super-blocks
    stacks: tuple[tuple[tuple[Layer, ...], int], ...]
    act: str = "swiglu"        # swiglu | geglu | gelu (dense FFN act)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rope_theta: float = 500000.0
    qk_norm: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    gemma_norm: bool = False   # (1 + w) RMSNorm scale convention
    # encoder-decoder / multimodal:
    encoder: Optional["ModelCfg"] = None   # audio/text encoder (enc-dec)
    cross_source: str = "none"             # none | image | encoder
    n_cross_tokens: int = 0                # image/frame token count stub
    frontend: str = "none"                 # none | audio | vision (stub embeds)
    dtype: str = "bfloat16"
    # serving
    max_seq: int = 32768
    kv_quant: bool = False     # int8 KV cache (per-token-per-head scales)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 512 (the pad rows are masked
        out of the logits)."""
        if not self.vocab:
            return 0
        return -(-self.vocab // 512) * 512

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.stacks)

    @property
    def layers_flat(self) -> tuple[Layer, ...]:
        out: list[Layer] = []
        for p, r in self.stacks:
            out.extend(list(p) * r)
        return tuple(out)

    def param_count(self) -> int:
        """Parameters of the model, counted from its specs (no allocation)."""
        from ..models import params as pm
        from ..models import transformer

        return pm.n_params(transformer.param_specs(self))


_REGISTRY: dict[str, ModelCfg] = {}

# the reference's other configs, and the item of ROADMAP.md's Queue A
# (item 6, the rest of the LM scaffolding) that brings their layers
LATER = {
    "llama-3.2-vision-90b": "cross-attention and the vision front end",
    "seamless-m4t-large-v2": "the encoder-decoder and the audio front end",
}


def register(cfg: ModelCfg) -> ModelCfg:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelCfg:
    _load_all()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in LATER:
        raise KeyError(
            f"config {name!r} needs {LATER[name]}, which the port does not have yet: a later "
            f"slice brings it (ROADMAP.md, Queue A item 6); the port runs {sorted(_REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from . import (  # noqa: F401  (register their configs)
        gemma3_4b, gemma_2b, granite_moe_3b, jamba_v01_52b, kimi_k2, llama3_2_1b, mamba2_1p3b,
        starcoder2_15b)
