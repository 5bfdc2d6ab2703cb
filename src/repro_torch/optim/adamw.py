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

``update_`` updates the parameters and moments in place, a leaf at a time
and a large leaf a slice of its leading (layer) axis at a time, so no
whole copy of the state is ever live: the train step of a 3 B parameter
model holds its fp32 moments (24 GB) once.  A step that ``finite`` marks
as skipped leaves every tensor as it was (``torch.where``, no host sync).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

# the JAX package's defaults, the only values the train step uses
B1, B2, EPS = 0.9, 0.95, 1e-8
WEIGHT_DECAY = 0.1
GRAD_CLIP = 1.0  # global L2 norm
# leaves above this many elements are updated a slice of their leading
# axis at a time (the stacked (30, 3072, 12288) MLP leaf of StarCoder2-3B
# would be 4.5 GB per fp32 temporary)
SLICE_ELEMENTS = 1 << 27


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


def _slices(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``t`` itself, or views of at most ``SLICE_ELEMENTS`` elements along
    its leading axis."""
    if t.numel() <= SLICE_ELEMENTS or t.dim() < 2:
        return (t,)
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return t.split(rows, dim=0)


def _squares(ts, device) -> torch.Tensor:
    """The sum of squares of the tensors ``ts`` in fp32, a large one a
    slice at a time (0 for none)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for t in ts:
        for s in _slices(t):
            g = s.float()
            total = total + torch.sum(g * g)
    return total


@torch.no_grad()
def global_norm(grads: dict[str, torch.Tensor], *, group=None,
                split=()) -> torch.Tensor:
    """The global L2 norm of the gradients in fp32 (a 0-d tensor).  An
    FSDP rank's (``group`` its data group, ``split`` the keys of the
    leaves it holds as blocks): the square root of the blocks' sum of
    squares summed over the group, plus the whole leaves' counted once."""
    device = next(iter(grads.values())).device
    if group is None:
        return torch.sqrt(_squares(grads.values(), device))
    blocks = _squares((g for k, g in grads.items() if k in split), device)
    dist.all_reduce(blocks, group=group)
    return torch.sqrt(blocks + _squares(
        (g for k, g in grads.items() if k not in split), device))


@torch.no_grad()
def update_(grads: dict[str, torch.Tensor], state: AdamWState,
            params: dict[str, torch.Tensor], *, lr, grad_norm: torch.Tensor,
            finite: torch.Tensor) -> None:
    """One AdamW step in place on ``params``, ``state.m``, ``state.v`` and
    ``state.count``, from the gradients and their global norm
    ``grad_norm`` (clipped to ``GRAD_CLIP``).  Where the 0-d bool
    ``finite`` is false every tensor keeps its value.  ``lr`` may be a
    number or a 0-d tensor."""
    scale = torch.where(grad_norm > GRAD_CLIP, GRAD_CLIP / (grad_norm + 1e-9),
                        torch.ones_like(grad_norm))
    count = state.count + 1
    b1c = 1 - B1 ** count.float()
    b2c = 1 - B2 ** count.float()
    for k, p in params.items():
        decay = p.ndim >= 2  # decay matrices only (standard practice)
        for ps, gs, ms, vs in zip(_slices(p), _slices(grads[k]),
                                  _slices(state.m[k]), _slices(state.v[k])):
            g = gs.float() * scale
            m = B1 * ms + (1 - B1) * g
            v = B2 * vs + (1 - B2) * (g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + EPS)
            if decay:
                upd = upd + WEIGHT_DECAY * ps.float()
            new = (ps.float() - lr * upd).to(ps.dtype)
            ms.copy_(torch.where(finite, m, ms))
            vs.copy_(torch.where(finite, v, vs))
            ps.copy_(torch.where(finite, new, ps))
    state.count.copy_(torch.where(finite, count, state.count))

