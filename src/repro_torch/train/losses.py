"""Per-family loss functions (counterpart of ``repro/train/losses.py``).

Only the conv family is ported: its batch is ``{'noisy', 'clean',
'peaks'}``, each (B, W).  The LM families' losses wait in ROADMAP.md
queue A.
"""
from __future__ import annotations

from repro_torch.core import blocks


def make_loss_fn(cfg):
    """``loss(model, batch) -> (loss, aux)`` for the config's family."""
    if cfg.family != "conv":
        raise NotImplementedError(
            f"the {cfg.family!r} family's loss is not ported to repro_torch "
            "yet: only the conv family is (ROADMAP.md queue A)")

    def conv_loss(model, batch):
        return blocks.loss_fn(model, cfg, batch)

    return conv_loss
