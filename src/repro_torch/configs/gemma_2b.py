"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256.  [arXiv:2403.08295; hf]

A copy of the JAX package's ``configs/gemma_2b.py``, field for field.
"""

from .base import Layer, ModelCfg, register

CFG = register(ModelCfg(
    name="gemma-2b",
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    stacks=(((Layer(mixer="attn"),), 18),),
    act="geglu",
    rope_theta=1e4,
    gemma_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    max_seq=8192,
))

SMOKE = ModelCfg(
    name="gemma2b-smoke",
    d_model=64, n_heads=4, n_kv=1, head_dim=16, d_ff=256, vocab=128,
    stacks=(((Layer(mixer="attn"),), 2),),
    act="geglu", gemma_norm=True, embed_scale=True, max_seq=64,
)
