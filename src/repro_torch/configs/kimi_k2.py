"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared), ~1T total / 32B active.
Paper-table arch.  [arXiv:2501.* Kimi K2; unverified]

A copy of the JAX package's ``configs/kimi_k2.py``, field for field.
Layer 0 is a dense-FFN layer, layers 1..60 are MoE (DeepSeek-V3-style
first-layer-dense).
"""

from .base import Layer, ModelCfg, MoECfg, register

CFG = register(ModelCfg(
    name="kimi-k2-1t-a32b",
    d_model=7168,
    n_heads=64,
    n_kv=8,
    head_dim=112,
    d_ff=2048 * 9,            # dense layer-0 FFN (DeepSeek-style wide dense)
    vocab=163840,
    stacks=(
        ((Layer(mixer="attn", moe=False),), 1),
        ((Layer(mixer="attn", moe=True),), 60),
    ),
    act="swiglu",
    moe=MoECfg(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
               capacity_factor=1.25),
    rope_theta=5e4,
    tie_embeddings=False,
    max_seq=131072,
))

SMOKE = ModelCfg(
    name="kimi-smoke",
    d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=128,
    stacks=(
        ((Layer(mixer="attn", moe=False),), 1),
        ((Layer(mixer="attn", moe=True),), 2),
    ),
    act="swiglu",
    moe=MoECfg(n_experts=8, top_k=2, d_ff=32, n_shared=1, capacity_factor=8.0),
    tie_embeddings=False, max_seq=64,
)
