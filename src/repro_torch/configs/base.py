"""Model configs of the port: the conv-family fields of the JAX package's
``ModelConfig`` (``repro/configs/base.py``) and its registry.

Only the fields the conv family reads are kept.  The LM families are not
ported yet; asking for one raises ``NotImplementedError`` that names the
ROADMAP queue they wait in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["conv"]

# Architectures of the JAX package whose families the port does not have
# yet (ROADMAP.md, queue A: the LM model zoo and the SSM/hybrid models).
NOT_PORTED = (
    "deepseek-v3-671b", "internvl2-2b", "mamba2-370m", "moonshot-v1-16b-a3b",
    "qwen2-7b", "qwen3-14b", "qwen3-8b", "starcoder2-3b", "whisper-large-v3",
    "zamba2-7b",
)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    conv_channels: int = 0
    conv_filter: int = 0
    conv_dilation: int = 1
    dtype: str = "float32"
    source: str = ""


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _load_all()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: only the conv "
            "family (atacworks, atacworks-bf16) is; the other families wait "
            "in ROADMAP.md queue A")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests: C <= 8, S <= 9, fp32.  The
    conv stack keeps its 25 layers."""
    small = dict(conv_channels=min(cfg.conv_channels, 8),
                 conv_filter=min(cfg.conv_filter, 9), dtype="float32")
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


def _load_all() -> None:
    from . import atacworks  # noqa: F401  (registers on import)
