"""Model configs of the port: the fields of the JAX package's
``ModelConfig`` (``repro/configs/base.py``) that the ported families read,
and its registry.

The conv family (AtacWorks) and the SSM family (Mamba2) are ported.  The
other families raise ``NotImplementedError`` that names the ROADMAP queue
they wait in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Family = Literal["conv", "ssm"]

# Architectures of the JAX package whose families the port does not have
# yet (ROADMAP.md, queue A: the LM model zoo and the hybrid models).
NOT_PORTED = (
    "deepseek-v3-671b", "internvl2-2b", "moonshot-v1-16b-a3b", "qwen2-7b",
    "qwen3-14b", "qwen3-8b", "starcoder2-3b", "whisper-large-v3",
    "zamba2-7b",
)


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
    # language models (the SSM family)
    n_layers: int = 0
    d_model: int = 0
    vocab_size: int = 0
    norm: str = "rmsnorm"        # only 'rmsnorm' is ported
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    pos_embedding: str = "none"  # only 'none' is ported
    ssm: Optional[SSMConfig] = None
    # conv nets (AtacWorks)
    conv_channels: int = 0
    conv_filter: int = 0
    conv_dilation: int = 1
    # numerics
    dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing"  # only 'nothing' is ported
    # chunk of the streamed cross-entropy (0: the full (B, T, V) logits);
    # only 0 is ported
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
            "family (atacworks, atacworks-bf16) and the SSM family "
            "(mamba2-370m) are; the other families wait in ROADMAP.md "
            "queue A")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests, fp32.  Conv: C <= 8,
    S <= 9 (the stack keeps its 25 layers).  SSM: the JAX package's
    reduction (2 layers, d_model 64, vocab <= 256, d_state 16, head_dim 8,
    chunk 16, remat off)."""
    small: dict = dict(dtype="float32")
    if cfg.family == "conv":
        small.update(conv_channels=min(cfg.conv_channels, 8),
                     conv_filter=min(cfg.conv_filter, 9))
    if cfg.family == "ssm":
        small.update(n_layers=min(cfg.n_layers, 2), d_model=64,
                     vocab_size=min(cfg.vocab_size, 256), remat=False,
                     ssm=dataclasses.replace(cfg.ssm, d_state=16,
                                             head_dim=8, chunk=16))
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


def _load_all() -> None:
    from . import atacworks, mamba2_370m  # noqa: F401  (register on import)
