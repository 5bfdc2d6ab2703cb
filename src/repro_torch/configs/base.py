"""Model configs of the port: the fields of the JAX package's
``ModelConfig`` (``repro/configs/base.py``) that the ported families read,
and its registry.

The conv family (AtacWorks), the SSM family (Mamba2), the dense
transformers (StarCoder2, Qwen2, Qwen3), the encoder-decoder family
(Whisper), the hybrid family (Zamba2) and the MoE family (Moonlight, and
DeepSeek-V3 with its Multi-head Latent Attention, ``MLAConfig``) and
the VLM (InternVL2, whose image embeddings come before the text) are
ported: every architecture of the JAX package's registry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Family = Literal["conv", "ssm", "dense", "encdec", "hybrid", "moe", "vlm"]

# Architectures of the JAX package whose families the port does not have
# yet: none.
NOT_PORTED: tuple[str, ...] = ()


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0            # shared (always-on) experts
    score_fn: str = "softmax"    # 'softmax' | 'sigmoid' (DeepSeek-V3)
    routed_scaling: float = 1.0
    first_dense_layers: int = 0  # leading dense layers (DeepSeek/Moonlight)
    d_ff_dense: int = 0          # d_ff of those dense layers
    capacity_factor: float = 0.0  # 0: dropless (sorted grouped products)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3): the query through a
    ``q_lora_rank`` bottleneck, keys and values from a ``kv_lora_rank``
    latent, each head's key ``qk_nope_head_dim`` wide plus a shared
    rotary key of ``qk_rope_head_dim``, values ``v_head_dim``."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128             # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    # language models (the SSM, dense, encoder-decoder and hybrid
    # families);
    # n_layers counts the decoder's layers of an encoder-decoder
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    mlp_act: str = "swiglu"      # 'swiglu' | 'gelu' (tanh form)
    mlp_bias: bool = False
    tie_embeddings: bool = False
    # 'rope' | 'sinusoidal' | 'learned' | 'none'
    pos_embedding: str = "rope"
    max_position: int = 1 << 20
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Zamba2): the shared attention block is applied after every
    # layer i with i % attn_every == attn_every - 1
    attn_every: int = 0
    # encoder-decoder (Whisper): encoder layers, and the frames the
    # encoder takes (the conv frontend's output width)
    n_encoder_layers: int = 0
    encoder_width: int = 0
    # VLM (InternVL2): the image embeddings (B, n_image_tokens, d_model)
    # put before the text tokens (the vision frontend is not modelled)
    n_image_tokens: int = 0
    # conv nets (AtacWorks)
    conv_channels: int = 0
    conv_filter: int = 0
    conv_dilation: int = 1
    # numerics
    dtype: str = "float32"
    remat: bool = True
    # 'nothing' (recompute every activation) or 'dots' (keep the outputs
    # of the products with no batch dimension; models/common.py)
    remat_policy: str = "nothing"
    attn_chunk: int = 256        # q-chunk of the chunked causal attention
    # attention: 'chunked' (plain PyTorch, the (Tq, Tk) scores per q-chunk)
    # or 'flash' (the hand-written kernels, kernels/flash_attention.py)
    attn_impl: str = "chunked"
    # chunk of the streamed cross-entropy (0: the full (B, T, V) logits;
    # train/losses.py streamed_xent)
    xent_chunk: int = 0
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab rounded up to a multiple of 256 (the JAX
        package's convention); logits above ``vocab_size`` are masked."""
        if self.vocab_size == 0:
            return 0
        return (self.vocab_size + 255) // 256 * 256


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry-run's cells (JAX's ``ShapeConfig``):
    a train step, a prefill, or a decode step of one new token against a
    KV cache of ``seq_len``."""
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int
    microbatch: int = 0          # 0: the launcher picks (train's accum)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# the architectures that run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = {"mamba2-370m", "zamba2-7b"}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests, fp32.  Conv: C <= 8,
    S <= 9 (the stack keeps its 25 layers).  SSM, dense and
    encoder-decoder: the JAX package's reduction (2 layers, d_model 64,
    vocab <= 256, remat off; SSM: d_state 16, head_dim 8, chunk 16; dense
    and encoder-decoder: 4 heads over <= 2 KV heads of 16, d_ff 128,
    max_position 4096, attn_chunk 64; encoder-decoder also 2 encoder
    layers over 64 frames, so its self-attention groups 2 query heads a
    KV head while its cross-attention keeps the 4 heads).  Hybrid: both
    (the SSM's and the attention's), with 4 layers and ``attn_every`` 2,
    so the shared block is applied twice, as GQA of 2 heads a KV head
    where the full width has one.  MoE: the dense one (its ``d_ff`` stays
    0) with JAX's caps on the experts: <= 8 experts, top_k <= 2,
    ``d_ff_expert`` 32, <= 1 leading dense layer of ``d_ff_dense`` 128.
    MLA: JAX's ranks and head widths q_lora 32, kv_lora 16, nope 16,
    rope 8, v 16.  VLM: the dense one with 8 image tokens."""
    small: dict = dict(dtype="float32")
    if cfg.family == "conv":
        small.update(conv_channels=min(cfg.conv_channels, 8),
                     conv_filter=min(cfg.conv_filter, 9))
    if cfg.family in ("ssm", "hybrid"):
        small.update(n_layers=min(cfg.n_layers, 2), d_model=64,
                     vocab_size=min(cfg.vocab_size, 256), remat=False,
                     ssm=dataclasses.replace(cfg.ssm, d_state=16,
                                             head_dim=8, chunk=16))
    if cfg.family in ("dense", "encdec", "hybrid", "moe", "vlm"):
        small.update(n_layers=min(cfg.n_layers, 2), d_model=64, n_heads=4,
                     n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
                     d_ff=128 if cfg.d_ff else 0,
                     vocab_size=min(cfg.vocab_size, 256),
                     max_position=4096, remat=False, attn_chunk=64)
    if cfg.moe:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0)
    if cfg.mla:
        small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8,
                                 v_head_dim=16)
    if cfg.family == "encdec":
        small.update(n_encoder_layers=2, encoder_width=64)
    if cfg.n_image_tokens:
        small["n_image_tokens"] = 8
    if cfg.attn_every:
        small.update(attn_every=2, n_layers=4)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


def _load_all() -> None:
    from . import (atacworks, deepseek_v3_671b,  # noqa: F401
                   internvl2_2b, mamba2_370m,  # (register on import)
                   moonshot_v1_16b_a3b,
                   qwen2_7b, qwen3_8b, qwen3_14b, starcoder2_3b,
                   whisper_large_v3, zamba2_7b)
