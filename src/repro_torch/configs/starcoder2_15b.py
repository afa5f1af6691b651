"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE, a plain GELU MLP, untied head.  [arXiv:2402.19173; hf]

A copy of the JAX package's ``configs/starcoder2_15b.py``, field for field.
"""

from .base import Layer, ModelCfg, register

CFG = register(ModelCfg(
    name="starcoder2-15b",
    d_model=6144,
    n_heads=48,
    n_kv=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    stacks=(((Layer(mixer="attn"),), 40),),
    act="gelu",                  # starcoder2 uses a plain GELU MLP
    rope_theta=1e5,
    tie_embeddings=False,
    norm_eps=1e-5,
))

SMOKE = ModelCfg(
    name="starcoder2-smoke",
    d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=256, vocab=128,
    stacks=(((Layer(mixer="attn"),), 2),),
    act="gelu", tie_embeddings=False, max_seq=64,
)
