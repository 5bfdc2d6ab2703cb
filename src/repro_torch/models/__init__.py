"""Model registry of the port (counterpart of ``repro/models/__init__.py``):
``get_model(cfg)`` returns the module that builds the config's family, and
``init_model`` builds the model of any ported family from a seed.

Among the language models the SSM family (Mamba2), the dense
transformers, the MoE transformers (Moonlight; DeepSeek-V3, whose
attention is MLA, ``models/mla.py``), the encoder-decoder (Whisper) and
the hybrid (Zamba2) are ported, each module with the
functional surface of the JAX package's (``repro/models/__init__.py``),
the model an ``nn.Module``:

    init_params(cfg, *, seed, device) -> model
    forward(model, tokens, *, last_only=False, ...) -> logits
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    decode_step(model, cache, tokens, pos) -> (logits, cache)

(an MLA model's ``decode_step`` also takes ``absorb``)

An MoE model's ``forward`` returns ``(logits, aux)``, aux its summed
load-balance loss, as the JAX package's ``forward`` does for every
family.

``decode_step`` updates the cache in place and returns it.  Whisper's
``forward`` also takes the encoder's ``frames``, its ``init_cache`` an
``enc_len``, and ``whisper.fill_cross_cache`` fills the cross-attention
K/V before the first decode step.  The conv family's model is
``repro_torch.core.blocks``, which serves through ring-buffer streaming
instead of a cache.
"""
from __future__ import annotations


def get_model(cfg):
    """The model module of ``cfg.family`` (the surface above)."""
    if cfg.family == "ssm":
        from repro_torch.models import mamba2
        return mamba2
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "encdec":
        from repro_torch.models import whisper
        return whisper
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return zamba2
    raise NotImplementedError(
        f"the {cfg.family!r} family's model is not ported to repro_torch "
        "yet: among the language models only the ssm (mamba2), dense and "
        "moe (transformer, MLA among them), encdec (whisper) and hybrid "
        "(zamba2) families are; the vlm waits in ROADMAP.md queue A")


def init_model(cfg, *, seed: int = 0, device="cpu"):
    """The ``nn.Module`` of the config's family with seeded weights: the
    AtacWorks stack for ``conv``, the language model otherwise."""
    if cfg.family == "conv":
        from repro_torch.core import blocks
        return blocks.init_params(cfg, seed=seed, device=device)
    return get_model(cfg).init_params(cfg, seed=seed, device=device)
