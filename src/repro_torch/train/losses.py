"""Per-family loss functions (counterpart of ``repro/train/losses.py``).

Batch layouts:
  conv: ``{'noisy', 'clean', 'peaks'}``, each (B, W);
  ssm, dense, hybrid:  ``{'tokens', 'labels'}``, each (B, T) int32;
  encdec: those and ``'frames'`` (B, encoder_width, d_model).

The other LM families' losses (MoE, VLM), and the streamed
cross-entropy (``cfg.xent_chunk``), wait in ROADMAP.md queue A.
"""
from __future__ import annotations

import torch

from repro_torch.core import blocks


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits fp32 (B, T, V), labels int (B, T) -> mean NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def make_loss_fn(cfg, *, grad_reduce=None,
                 grad_reduce_chunks: int | None = None, model_group=None,
                 model_reduce_chunks: int | None = None):
    """``loss(model, batch) -> (loss, aux)`` for the config's family.

    ``grad_reduce`` marks the loss as running on one rank's share of the
    batch (``train/data_parallel.py``): the conv family threads it, and
    ``grad_reduce_chunks``, down to every layer, so each layer's weight
    and bias gradients are summed over the data group right after its
    bwd-weight pass.  The other families ignore both: their data-parallel
    gradient function reduces the whole gradient list instead.
    ``model_group`` and ``model_reduce_chunks`` K-shard the conv family's
    layers (``blocks.forward``); the other families have no model axis
    here."""
    if cfg.family == "conv":
        def conv_loss(model, batch):
            return blocks.loss_fn(model, cfg, batch, grad_reduce=grad_reduce,
                                  grad_reduce_chunks=grad_reduce_chunks,
                                  model_group=model_group,
                                  model_reduce_chunks=model_reduce_chunks)

        return conv_loss
    if cfg.family not in ("ssm", "dense", "encdec", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family!r} family's loss is not ported to repro_torch "
            "yet: only the conv, ssm, dense, encdec and hybrid families' "
            "are (ROADMAP.md queue A)")
    if cfg.xent_chunk:
        raise NotImplementedError(
            "the streamed cross-entropy (xent_chunk > 0) is not ported to "
            "repro_torch yet (ROADMAP.md queue A)")

    def lm_loss(model, batch):
        """Mean next-token NLL over the full fp32 logits.  JAX's total is
        ``nll + AUX_WEIGHT * aux``, where aux is the MoE load-balance loss:
        0 for Mamba2, the dense transformers and Zamba2, so the total is
        the NLL.  The encoder-decoder's logits are those of the tokens given
        the batch's frames, and its total is the NLL."""
        if cfg.family == "encdec":
            logits = model(batch["tokens"], frames=batch["frames"])
        else:
            logits = model(batch["tokens"])
        loss = softmax_xent(logits, batch["labels"])
        return loss, {"nll": loss}

    return lm_loss
