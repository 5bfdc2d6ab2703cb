"""Zamba2-7B (hybrid Mamba2 + one weight-shared attention block;
arXiv:2411.15242).  Same values as ``repro/configs/zamba2_7b.py``, with
the dtype written out (the port's default is fp32, the JAX package's
bf16).

81 Mamba2 layers, d_model 3584 (d_inner 7168, d_state 64, head_dim 64 ->
112 SSM heads, conv width 4 over 7,296 channels), and one weight-shared
transformer block (32 heads over 32 KV heads of 112, d_ff 14,336) applied
after every 6th layer: 13 applications.  Vocab 32,000, bf16, remat on.
"""
from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10000.0,
    ssm=SSMConfig(d_state=64, conv_width=4, expand=2, head_dim=64,
                  n_groups=1, chunk=128),
    attn_every=6,
    dtype="bfloat16",
    source="arXiv:2411.15242 (unverified tier)",
))
