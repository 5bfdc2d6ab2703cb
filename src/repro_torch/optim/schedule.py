"""LR schedules (counterpart of ``repro/optim/schedule.py``): pure
functions of the step counter.  ``step`` may be a number or a tensor; the
result is a 0-d fp32 tensor on the step's device, so a train step reads
its learning rate without waiting for the device."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, final_frac: float = 0.1):
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)
