"""Shared language-model pieces the ported families read (counterpart of
the matching parts of ``repro/models/common.py``): the RMS norm, token
embedding, the unembedding with its vocabulary padding masked, and
activation rematerialisation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

NEG_INF = -1e30  # the logit of a padded vocabulary column


def init_norm(cfg, d: int, dtype: torch.dtype) -> dict:
    """``{"scale": ones(d)}``: the RMS norm's parameters."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported to repro_torch yet: only "
            "'rmsnorm' is (ROADMAP.md queue A)")
    return {"scale": torch.ones(d, dtype=dtype)}


def apply_norm(scale: torch.Tensor, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMS norm in fp32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(x.dtype)


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Rows of the (padded_vocab, d_model) table for (B, T) token ids."""
    if cfg.pos_embedding != "none":
        raise NotImplementedError(
            f"pos_embedding {cfg.pos_embedding!r} is not ported to "
            "repro_torch yet (ROADMAP.md queue A)")
    return F.embedding(tokens, tok)


def logits_from_hidden(tok: torch.Tensor, unembed: torch.Tensor | None,
                       x: torch.Tensor, cfg) -> torch.Tensor:
    """fp32 logits (B, T, padded_vocab) from the final hidden state; the
    columns past ``vocab_size`` are ``NEG_INF``, so they take no
    probability and get no gradient."""
    w = tok.t() if cfg.tie_embeddings else unembed
    logits = (x @ w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def maybe_remat(fn, cfg):
    """``fn`` itself, or with ``cfg.remat`` a function that keeps none of
    ``fn``'s activations and recomputes them in the backward (JAX's
    ``nothing_saveable`` policy; the ``"dots"`` policy is not ported)."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported to repro_torch "
            "yet: only 'nothing' is (ROADMAP.md queue A)")

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return remat
