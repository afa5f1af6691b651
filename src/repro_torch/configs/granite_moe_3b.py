"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-*; hf]

A copy of the JAX package's ``configs/granite_moe_3b.py``, field for field.
Every layer is global attention with an MoE FFN (no shared expert).
"""

from .base import Layer, ModelCfg, MoECfg, register

CFG = register(ModelCfg(
    name="granite-moe-3b-a800m",
    d_model=1536,
    n_heads=24,
    n_kv=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    stacks=(((Layer(mixer="attn", moe=True),), 32),),
    act="swiglu",
    moe=MoECfg(n_experts=40, top_k=8, d_ff=512, n_shared=0),
    rope_theta=1e4,
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=4096,
))

SMOKE = ModelCfg(
    name="granite-smoke",
    d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=64, vocab=128,
    stacks=(((Layer(mixer="attn", moe=True),), 2),),
    act="swiglu", moe=MoECfg(n_experts=4, top_k=2, d_ff=32, capacity_factor=4.0), max_seq=64,
)
