"""Whisper-large-v3 (arXiv:2212.04356).  Same values as
``repro/configs/whisper_large_v3.py``.

Encoder-decoder: 32 encoder and 32 decoder layers, d_model 1280, 20 heads
over 20 KV heads (MHA) of 64, d_ff 5120, vocab 51,866, 128 mels, 1,500
encoder frames (the conv frontend's stride 2 over 3,000 mel columns),
LayerNorm, tanh-form GELU, learned decoder positions, sinusoidal encoder
positions, bf16, remat on.  The encoder takes precomputed frame
embeddings (B, 1500, 1280); the conv frontend that makes them from a mel
spectrogram runs the paper's conv kernel (``models/whisper.py``).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,                 # decoder layers
    n_encoder_layers=32,
    encoder_width=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    norm_eps=1e-5,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    attn_out_bias=True,
    pos_embedding="learned",
    max_position=1 << 16,
    dtype="bfloat16",
    source="arXiv:2212.04356 (unverified tier)",
))
