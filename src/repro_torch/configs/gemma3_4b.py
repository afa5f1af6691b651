"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-*; unverified]

A copy of the JAX package's ``configs/gemma3_4b.py``, field for field.
The 5 local layers per period use sliding-window attention (window 1024);
the 1-in-6 global layers use full causal attention.
34 = 5 x (5 local + 1 global) + 4 local.
"""

from .base import Layer, ModelCfg, register

WINDOW = 1024
_local = Layer(mixer="swa", window=WINDOW)
_global = Layer(mixer="attn")

CFG = register(ModelCfg(
    name="gemma3-4b",
    d_model=2560,
    n_heads=8,
    n_kv=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    stacks=(
        ((_local,) * 5 + (_global,), 5),
        ((_local,), 4),
    ),
    act="geglu",
    rope_theta=1e6,
    qk_norm=True,
    gemma_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    max_seq=131072,
))

SMOKE = ModelCfg(
    name="gemma3-smoke",
    d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256,
    stacks=(
        ((Layer(mixer="swa", window=8),) * 2 + (Layer(mixer="attn"),), 2),
    ),
    act="geglu", qk_norm=True, gemma_norm=True, embed_scale=True, max_seq=64,
)
