"""Moonlight-16B-A3B (Moonshot; hf:moonshotai/Moonlight-16B-A3B).  Same
values as ``repro/configs/moonshot_v1_16b_a3b.py``, with the dtype
written out (the port's default is fp32, the JAX package's bf16).

48 layers, d_model 2048, 16 query heads over 16 KV heads (MHA) of 128,
vocab 163,840, RoPE (theta 5e4), RMSNorm, SwiGLU.  The first layer is
dense (d_ff 11,264); the other 47 are MoE layers of 64 routed experts
(top-6, DeepSeek-V3-style sigmoid routing with routed scaling 2.446) of
d_ff 1,408 and 2 shared experts.  28.39 B parameters, 4.80 B active a
token (JAX's count).  bf16, remat on.
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=163840,
    rope_theta=50000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        score_fn="sigmoid",
        routed_scaling=2.446,
        first_dense_layers=1,
        d_ff_dense=11264,
    ),
    dtype="bfloat16",
    source="hf:moonshotai/Moonlight-16B-A3B",
))
