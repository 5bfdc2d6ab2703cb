"""Qwen3-14B.  Same values as ``repro/configs/qwen3_14b.py``.

40 layers, d_model 5120, 40 query heads over 8 KV heads of 128, d_ff
17408, vocab 151,936, per-head RMS norm on q and k, RoPE (theta 1e6),
SwiGLU, bf16.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    source="hf:Qwen/Qwen3-14B",
))
