"""Gradient compression with error feedback (counterpart of
``repro/optim/compression.py``).

Gradients are rounded to bf16 (to nearest even, as JAX's cast rounds);
the rounding residual is kept in an fp32 error-feedback buffer and added
back the next step, so the compressed optimizer trajectory follows the
uncompressed one.  The buffers are a dict keyed as the parameters
(``TrainState.ef``).  As in the JAX package's ``shard_map`` path, the
data-parallel train step compresses the gradients after their all-reduce,
which runs in fp32 inside the backward (``kernels/ops.py``).
"""
from __future__ import annotations

import torch


def init_error_feedback(params: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """fp32 zeros shaped as each parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compress(grads: dict[str, torch.Tensor], ef: dict[str, torch.Tensor]):
    """Returns (bf16 gradients, new error-feedback buffers)."""
    qs, es = {}, {}
    for k, g in grads.items():
        corrected = g.float() + ef[k]
        qs[k] = corrected.to(torch.bfloat16)
        es[k] = corrected - qs[k].float()
    return qs, es


def decompress(qgrads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: q.float() for k, q in qgrads.items()}
