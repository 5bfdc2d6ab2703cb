"""DeepSeek-V3 671B (arXiv:2412.19437).  Same values as
``repro/configs/deepseek_v3_671b.py``, with the dtype written out (the
port's default is fp32, the JAX package's bf16).

61 layers, d_model 7,168, 128 heads of Multi-head Latent Attention
(q_lora 1,536, kv_lora 512, nope 128 + rope 64 for the keys, v 128),
vocab 129,280, RoPE, RMSNorm, SwiGLU.  The first 3 layers are dense
(d_ff 18,432); the other 58 are MoE layers of 256 routed experts (top-8,
sigmoid routing with routed scaling 2.5) of d_ff 2,048 and 1 shared
expert.  671.03 B parameters, 37.55 B active a token (JAX's count).
bf16, remat on.  One card holds it only cut in depth (``chip_smoke.py``
registers the cuts it serves and trains).
"""
from .base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=0,
    vocab_size=129280,
    rope_theta=10000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        score_fn="sigmoid",
        routed_scaling=2.5,
        first_dense_layers=3,
        d_ff_dense=18432,
    ),
    dtype="bfloat16",
    source="arXiv:2412.19437",
))
