"""Train step factory (counterpart of ``repro/train/train_step.py``, single
device): loss -> gradients (with microbatch accumulation) -> non-finite
guard -> AdamW update.

The JAX step is a pure function of an immutable state.  Here the state's
model is an ``nn.Module`` and the step updates it in place: the global
gradient norm comes first, then ``adamw.update_`` overwrites the
parameters, the moments and the count leaf by leaf (no whole copy of the
state is live), and the step counter is replaced.  Nothing in the step
waits for the device: the learning rate comes from the step counter on
the device, and a non-finite loss or gradient norm skips the step with
``torch.where`` (old values kept), not with a host-side branch.  The step returns its metrics as 0-d tensors; the
caller decides when to read them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.optim import adamw, schedule
from repro_torch.train.losses import make_loss_fn


@dataclass
class TrainState:
    params: nn.Module        # the model; its parameters are the params
    opt: adamw.AdamWState
    step: torch.Tensor       # int32, 0-d, on the model's device


def init_state(model: nn.Module) -> TrainState:
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(params=model, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` consecutive slices of the batch (JAX's reshape to
    (accum, B // accum, ...))."""
    return [{k: v[i * (v.shape[0] // accum):(i + 1) * (v.shape[0] // accum)]
             for k, v in batch.items()} for i in range(accum)]


def make_train_step(cfg, *, accum_steps: int = 1, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000):
    """``train_step(state, batch) -> (state, metrics)``.  With
    ``accum_steps > 1`` the batch is split into that many microbatches;
    their gradients are summed in fp32 and divided, and the loss is their
    mean.  AdamW clips at global norm 1.0 and decays by 0.1 (its
    defaults).  ``metrics``: loss, grad_norm, lr and skipped, 1.0 where a
    non-finite loss or gradient norm left the state as it was."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(model, params, batch):
        loss, _ = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        names, params = zip(*model.named_parameters())
        if accum_steps > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
            lsum = 0.0
            for mb in _split_microbatches(batch, accum_steps):
                loss, g = grads_of(model, params, mb)
                gsum = [a + b.float() for a, b in zip(gsum, g)]
                lsum = lsum + loss
            grads = [g / accum_steps for g in gsum]
            loss = lsum / accum_steps
        else:
            loss, grads = grads_of(model, params, batch)

        lr = schedule.cosine_with_warmup(
            state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps)
        grads = dict(zip(names, grads))
        gnorm = adamw.global_norm(grads)
        finite = torch.isfinite(gnorm) & torch.isfinite(loss)
        adamw.update_(grads, state.opt, dict(zip(names, params)), lr=lr,
                      grad_norm=gnorm, finite=finite)
        state.step = state.step + 1
        return state, {"grad_norm": gnorm, "skipped": (~finite).float(),
                       "loss": loss, "lr": lr}

    return train_step
