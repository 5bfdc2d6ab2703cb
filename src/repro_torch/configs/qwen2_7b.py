"""Qwen2-7B (arXiv:2407.10671).  Same values as
``repro/configs/qwen2_7b.py``.

28 layers, d_model 3584, 28 query heads over 4 KV heads of 128, d_ff
18944, vocab 152,064, QKV biases, RoPE (theta 1e6), SwiGLU, bf16.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    source="arXiv:2407.10671",
))
