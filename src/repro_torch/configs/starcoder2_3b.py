"""StarCoder2-3B (arXiv:2402.19173).  Same values as
``repro/configs/starcoder2_3b.py``.

30 layers, d_model 3072, 24 query heads over 2 KV heads (GQA group 12) of
128, d_ff 12288, vocab 49,152, RoPE (theta 1e5), LayerNorm, GELU MLP,
biases on every projection, tied embeddings, bf16, remat on.  The
published model's 4,096-token sliding window equals the full causal mask
at its 4,096-token pretraining context, so the config has no window.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    norm_eps=1e-5,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    attn_out_bias=True,
    rope_theta=100_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2402.19173",
))
