"""AdamW with fp32 first and second moments (counterpart of
``repro/optim/adamw.py``), written as the JAX package's and not as
``torch.optim.AdamW``: global-norm clipping, bias correction from an
int32 step count, decoupled weight decay added to the update of
parameters with ``ndim >= 2`` only.

Parameters, gradients and moments are dicts keyed by state-dict name.
The decay rule reads each tensor's ``ndim``, which is the JAX leaf's: the
port keeps the JAX tree's shapes, Mamba2's per-layer vectors included
(``layers.mixer.A_log`` is (L, H), so it decays as in JAX, and
``final_norm.scale`` (D,) does not).
``update`` is functional: it returns new tensors and changes nothing it
is given, so a train step can keep the old values where a step is skipped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# the JAX package's defaults, the only values the train step uses
B1, B2, EPS = 0.9, 0.95, 1e-8
WEIGHT_DECAY = 0.1
GRAD_CLIP = 1.0  # global L2 norm


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor  # int32, 0-d


def init(params: dict[str, torch.Tensor]) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(params.values())).device
    return AdamWState(m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()},
                      count=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def update(grads: dict[str, torch.Tensor], state: AdamWState,
           params: dict[str, torch.Tensor], *, lr):
    """Returns ``(new_params, new_state, {"grad_norm"})``.  ``lr`` may be a
    number or a 0-d tensor; ``grad_norm`` is the global L2 norm of the
    gradients before clipping (a 0-d fp32 tensor)."""
    g32 = {k: g.float() for k, g in grads.items()}
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g32.values()))
    scale = torch.where(gnorm > GRAD_CLIP, GRAD_CLIP / (gnorm + 1e-9),
                        torch.ones_like(gnorm))
    g32 = {k: g * scale for k, g in g32.items()}

    count = state.count + 1
    b1c = 1 - B1 ** count.float()
    b2c = 1 - B2 ** count.float()
    new_m = {k: B1 * state.m[k] + (1 - B1) * g for k, g in g32.items()}
    new_v = {k: B2 * state.v[k] + (1 - B2) * (g * g) for k, g in g32.items()}

    def step(p, m, v):
        upd = (m / b1c) / (torch.sqrt(v / b2c) + EPS)
        if p.ndim >= 2:  # decay matrices only (standard practice)
            upd = upd + WEIGHT_DECAY * p.float()
        return (p.float() - lr * upd).to(p.dtype)

    new_params = {k: step(p, new_m[k], new_v[k]) for k, p in params.items()}
    return new_params, AdamWState(new_m, new_v, count), {"grad_norm": gnorm}
