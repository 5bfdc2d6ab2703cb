"""InternVL2-2B (arXiv:2404.16821).  Same values as
``repro/configs/internvl2_2b.py``.

The InternLM2-1.8B language model: 24 layers, d_model 2048, 16 query
heads over 8 KV heads of 128, d_ff 8192 (SwiGLU), vocab 92,553 (padded
to 92,672), RoPE (theta 1e6), RMSNorm, untied embeddings, bf16, remat
on.  The InternViT frontend is not modelled: 256 image embeddings
(B, 256, d_model), as its projector gives them, come before the text
tokens (``models/transformer.py forward(extra_embeds=)``).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    n_image_tokens=256,
    dtype="bfloat16",
    source="arXiv:2404.16821",
))
