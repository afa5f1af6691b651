"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]

A copy of the JAX package's ``configs/jamba_v01_52b.py``, field for field.
Period of 8 layers: attention at index 4, Mamba elsewhere; MoE FFN at odd
indices (every 2nd layer), dense FFN otherwise — the Jamba block layout.
Every Mamba layer carries an FFN.
"""

from .base import Layer, ModelCfg, MoECfg, SSMCfg, register

_m_d = Layer(mixer="mamba", moe=False)
_m_e = Layer(mixer="mamba", moe=True)
_a_d = Layer(mixer="attn", moe=False)
_a_e = Layer(mixer="attn", moe=True)

CFG = register(ModelCfg(
    name="jamba-v0.1-52b",
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    # indices:      0     1     2     3     4     5     6     7
    stacks=(((_m_d, _m_e, _m_d, _m_e, _a_d, _m_e, _m_d, _m_e), 4),),
    act="swiglu",
    moe=MoECfg(n_experts=16, top_k=2, d_ff=14336, n_shared=0),
    ssm=SSMCfg(d_state=16, head_dim=64, expand=2, n_groups=1, conv_kernel=4),
    rope_theta=1e4,
    tie_embeddings=False,
    norm_eps=1e-6,
    max_seq=262144,
))

SMOKE = ModelCfg(
    name="jamba-smoke",
    d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=128,
    stacks=(((Layer(mixer="mamba"), Layer(mixer="mamba", moe=True),
              Layer(mixer="attn"), Layer(mixer="mamba", moe=True)), 1),),
    act="swiglu",
    moe=MoECfg(n_experts=4, top_k=2, d_ff=64, capacity_factor=4.0),
    ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=8),
    tie_embeddings=False, max_seq=64,
)
