"""Mamba2-370M (SSD, attention-free; Dao & Gu 2024, arXiv:2405.21060).
Same values as ``repro/configs/mamba2_370m.py``.

48 layers, d_model 1024, d_inner 2048 (expand 2), d_state 128, head_dim 64
-> 32 SSM heads, causal depthwise conv of width 4, vocab 50,280 (padded to
50,432), bf16, remat on.
"""
from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab_size=50280,
    pos_embedding="none",
    ssm=SSMConfig(d_state=128, conv_width=4, expand=2, head_dim=64,
                  n_groups=1, chunk=128),
    dtype="bfloat16",
    source="arXiv:2405.21060 (unverified tier)",
))
