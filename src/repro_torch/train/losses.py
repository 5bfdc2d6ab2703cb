"""Per-family loss functions (counterpart of ``repro/train/losses.py``).

Batch layouts:
  conv: ``{'noisy', 'clean', 'peaks'}``, each (B, W);
  ssm, dense, moe, hybrid:  ``{'tokens', 'labels'}``, each (B, T) int32;
  vlm: those of the text and ``'patches'`` (B, n_image_tokens, d_model);
  encdec: those and ``'frames'`` (B, encoder_width, d_model).

The language models' total is ``nll + AUX_WEIGHT * aux``, aux the MoE
load-balance loss (0 outside the MoE family); with ``cfg.xent_chunk``
the NLL is the streamed cross-entropy.  The VLM's NLL is over the text
positions only.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import blocks
from repro_torch.models import common as cm

AUX_WEIGHT = 0.01  # the MoE load-balance loss's weight (JAX's)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits fp32 (B, T, V), labels int (B, T) -> mean NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def streamed_xent(model, hidden: torch.Tensor, labels: torch.Tensor,
                  cfg) -> torch.Tensor:
    """The mean NLL without the (B, T, V) fp32 logits (JAX's
    ``streamed_xent``): the unembedding runs over T-chunks of
    ``cfg.xent_chunk`` positions, each chunk's logits made inside one
    ``torch.utils.checkpoint``, so they live only inside it in the
    forward and are made again in the backward; the chunks' NLL sums are
    added in order.  hidden (B, T, D) is the final-normed hidden state,
    labels (B, T) int.  Where T is not a multiple of the chunk larger
    than it, the full logits, as JAX does."""
    B, T, _ = hidden.shape
    c = cfg.xent_chunk
    tok, unembed = cm.unembedding(model)  # an FSDP rank's: gathered once
    if not c or T <= c or T % c:
        return softmax_xent(cm.logits_from_hidden(tok, unembed, hidden, cfg),
                            labels)

    def chunk_nll(hc, lc):
        logits = cm.logits_from_hidden(tok, unembed, hc, cfg)  # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.long()[..., None])[..., 0]
        return (logz - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c])
        total = total + (torch.utils.checkpoint.checkpoint(
            chunk_nll, *args, use_reentrant=False)
            if torch.is_grad_enabled() else chunk_nll(*args))
    return total / (B * T)


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
    if cfg.family not in ("ssm", "dense", "encdec", "hybrid", "moe", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def lm_loss(model, batch):
        """The mean next-token NLL, streamed with ``cfg.xent_chunk``, and
        JAX's total ``nll + AUX_WEIGHT * aux``, aux the MoE load-balance
        loss (the total is the NLL itself for the families without one).
        The encoder-decoder's logits are those of the tokens given the
        batch's frames, over the full logits (JAX's ``encdec_loss``).  A
        VLM's NLL is that of the text positions, after the batch's image
        embeddings: JAX's ``vlm_loss`` slices the logits of every
        position to the text's, the port unembeds the text's hidden
        rows only, the same function without the image rows' logits
        (streamed with ``cfg.xent_chunk`` as the other families'; JAX's
        ignores it, and the VLM's config leaves it 0)."""
        if cfg.family == "encdec":
            loss = softmax_xent(model(batch["tokens"], frames=batch["frames"]),
                                batch["labels"])
            return loss, {"nll": loss}
        if cfg.family == "vlm":
            patches = batch["patches"]
            hidden = model(batch["tokens"], extra_embeds=patches,
                           hidden_only=True)
            nll = streamed_xent(model, hidden[:, patches.shape[1]:],
                                batch["labels"], cfg)
            return nll, {"nll": nll}
        out = model(batch["tokens"], hidden_only=bool(cfg.xent_chunk))
        out, aux = out if cfg.family == "moe" else (out, None)
        if cfg.xent_chunk:
            nll = streamed_xent(model, out, batch["labels"], cfg)
        else:
            nll = softmax_xent(out, batch["labels"])
        total = nll if aux is None else nll + AUX_WEIGHT * aux
        return total, {"nll": nll}

    return lm_loss
