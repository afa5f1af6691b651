"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]

A copy of the JAX package's ``configs/llama3_2_1b.py``, field for field.
"""

from .base import Layer, ModelCfg, register

CFG = register(ModelCfg(
    name="llama3.2-1b",
    d_model=2048,
    n_heads=32,
    n_kv=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    stacks=(((Layer(mixer="attn"),), 16),),
    act="swiglu",
    rope_theta=5e5,
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=131072,
))

SMOKE = ModelCfg(
    name="llama1b-smoke",
    d_model=64, n_heads=8, n_kv=2, head_dim=8, d_ff=192, vocab=128,
    stacks=(((Layer(mixer="attn"),), 2),),
    act="swiglu", max_seq=64,
)
