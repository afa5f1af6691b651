"""mamba2-1.3b [ssm] — 48L d_model=2048 attn-free, vocab=50280,
ssm_state=128 (SSD, state-space duality).  [arXiv:2405.21060; unverified]

A copy of the JAX package's ``configs/mamba2_1p3b.py``, field for field.
"""

from .base import Layer, ModelCfg, SSMCfg, register

CFG = register(ModelCfg(
    name="mamba2-1.3b",
    d_model=2048,
    n_heads=0,
    n_kv=0,
    head_dim=0,
    d_ff=0,                     # attention/FFN-free: mixer is the whole layer
    vocab=50280,
    stacks=(((Layer(mixer="mamba", ffn=False),), 48),),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1, conv_kernel=4),
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=1048576,
))

SMOKE = ModelCfg(
    name="mamba2-smoke",
    d_model=64, n_heads=0, n_kv=0, head_dim=0, d_ff=0, vocab=128,
    stacks=(((Layer(mixer="mamba", ffn=False),), 2),),
    ssm=SSMCfg(d_state=16, head_dim=16, expand=2, n_groups=1, conv_kernel=4, chunk=8),
    max_seq=64,
)
