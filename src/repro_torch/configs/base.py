"""Model configs of the port: the fields of the JAX package's
``ModelConfig`` (``repro/configs/base.py``) that the ported families read,
and its registry.

The conv family (AtacWorks), the SSM family (Mamba2), the dense
transformers (StarCoder2, Qwen2, Qwen3), the encoder-decoder family
(Whisper), the hybrid family (Zamba2) and the MoE family (Moonlight) are
ported.  The other families (MLA, VLM) raise ``NotImplementedError`` that
names the ROADMAP queue they wait in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Family = Literal["conv", "ssm", "dense", "encdec", "hybrid", "moe"]

# Architectures of the JAX package whose families the port does not have
# yet (ROADMAP.md, queue A: MLA and VLM).
NOT_PORTED = ("deepseek-v3-671b", "internvl2-2b")


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
    ssm: Optional[SSMConfig] = None
    # hybrid (Zamba2): the shared attention block is applied after every
    # layer i with i % attn_every == attn_every - 1
    attn_every: int = 0
    # encoder-decoder (Whisper): encoder layers, and the frames the
    # encoder takes (the conv frontend's output width)
    n_encoder_layers: int = 0
    encoder_width: int = 0
    # conv nets (AtacWorks)
    conv_channels: int = 0
    conv_filter: int = 0
    conv_dilation: int = 1
    # numerics
    dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing"  # only 'nothing' is ported
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


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _load_all()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: only the conv "
            "family (atacworks, atacworks-bf16), the SSM family "
            "(mamba2-370m), the dense transformers (starcoder2-3b, "
            "qwen2-7b, qwen3-8b, qwen3-14b), the encoder-decoder "
            "(whisper-large-v3), the hybrid (zamba2-7b) and the MoE "
            "(moonshot-v1-16b-a3b) are; MLA and the VLM wait in ROADMAP.md "
            "queue A")
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
    ``d_ff_expert`` 32, <= 1 leading dense layer of ``d_ff_dense`` 128."""
    small: dict = dict(dtype="float32")
    if cfg.family == "conv":
        small.update(conv_channels=min(cfg.conv_channels, 8),
                     conv_filter=min(cfg.conv_filter, 9))
    if cfg.family in ("ssm", "hybrid"):
        small.update(n_layers=min(cfg.n_layers, 2), d_model=64,
                     vocab_size=min(cfg.vocab_size, 256), remat=False,
                     ssm=dataclasses.replace(cfg.ssm, d_state=16,
                                             head_dim=8, chunk=16))
    if cfg.family in ("dense", "encdec", "hybrid", "moe"):
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
    if cfg.family == "encdec":
        small.update(n_encoder_layers=2, encoder_width=64)
    if cfg.attn_every:
        small.update(attn_every=2, n_layers=4)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


def _load_all() -> None:
    from . import (atacworks, mamba2_370m,  # noqa: F401
                   moonshot_v1_16b_a3b, qwen2_7b,  # (register on import)
                   qwen3_8b, qwen3_14b, starcoder2_3b, whisper_large_v3,
                   zamba2_7b)
