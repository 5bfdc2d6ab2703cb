"""Candidate enumeration for the conv1d tuner (counterpart of
``repro/tune/space.py``, re-derived for this card's kernels).

A candidate is ``(backend, tile, body)`` for one pass of one layer:

  * ``cuda`` — the hand-written kernels.  The forward and bwd-data passes
    run ``conv1d_fwd``, whose knob is its register tile ``tile`` (J * 100
    + KT: J columns x KT filters a thread), one of the instantiated set
    for the pass's filter count (``conv1d_brgemm.fwd_tiles``: 616, 408,
    204, 104 for more than one filter, 1601, 201, 101 for one; bwd-data's
    filters are the layer's C).  The bwd-weight pass runs
    ``conv1d_bwd_weight``, whose knob is its ``body`` (``"taps"`` or
    ``"unit"``).  The depthwise kernels have no knob: backend only.
  * ``library`` — cuDNN through ``F.conv1d`` and ``torch.nn.grad``, the
    counterpart of the JAX package's ``xla``; no knob.
  * ``ref`` — the plain version, the host's counterpart of ``cuda``: on
    the CPU ("cpu" device kind) it takes ``cuda``'s place, since a CUDA
    kernel cannot run there.

Legality has one source, the kernels' own rule: a tile or body is
enumerated only where the ``.cu`` says it may run the pass's shape
(``conv1d_brgemm.fwd_tile`` / ``bwd_weight_body``, which build and ask the
library, so on the card); the depthwise kernels take at most
``conv1d_brgemm.DW_MAX_TAPS`` taps.  ``allowed`` may be replaced (the CPU
tests pass their own) so the enumeration can be exercised without a card.
The JAX package's ``nblk`` and ``pipe`` axes have no counterpart on this
card and are never enumerated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.kernels import conv1d_brgemm as _k
from repro_torch.roofline.analysis import is_gpu

from .problem import PASS_BWD_DATA, PASS_BWD_WEIGHT, ConvProblem

BACKENDS = ("cuda", "library", "ref")


@dataclasses.dataclass(frozen=True)
class Candidate:
    backend: str                 # 'cuda' | 'library' | 'ref'
    tile: int | None = None      # conv1d_fwd's register tile (cuda)
    body: str | None = None      # conv1d_bwd_weight's body (cuda)

    def as_entry(self) -> dict:
        return {"backend": self.backend, "tile": self.tile,
                "body": self.body}


def kernel_shape(prob: ConvProblem) -> tuple[int, int, int, int, int, int]:
    """(N, C, K, S, Wp, dilation) of the pass's kernel call: bwd-data runs
    the forward kernel with C and K swapped on the cotangent padded by the
    span on both sides."""
    span = prob.span
    if prob.pass_ == PASS_BWD_DATA:
        return (prob.N, prob.K, prob.C, prob.S, prob.Q + 2 * span,
                prob.dilation)
    return prob.N, prob.C, prob.K, prob.S, prob.Q + span, prob.dilation


def kernel_allows(prob: ConvProblem, cand: Candidate, device: int = 0
                  ) -> bool:
    """Whether the pass's CUDA kernel may run the candidate at this shape,
    by the kernel's own rule (asks the library on GPU ``device``)."""
    if prob.depthwise:
        return prob.S <= _k.DW_MAX_TAPS
    shape = kernel_shape(prob)
    if prob.pass_ == PASS_BWD_WEIGHT:
        return _k.bwd_weight_body(*shape, body=cand.body,
                                  device=device) is not None
    return _k.fwd_tile(*shape, tile=cand.tile, device=device) is not None


def cuda_candidates(prob: ConvProblem) -> list[Candidate]:
    """Every knob value the pass's kernel instantiates, legal or not."""
    if prob.depthwise:
        return [Candidate("cuda")]
    if prob.pass_ == PASS_BWD_WEIGHT:
        return [Candidate("cuda", body=b) for b in _k.BWD_BODIES]
    return [Candidate("cuda", tile=t) for t in _k.fwd_tiles(prob.n_filters)]


def enumerate_candidates(
        prob: ConvProblem, *, device_kind: str,
        backends: tuple[str, ...] | None = None,
        allowed: Callable[[ConvProblem, Candidate], bool] = kernel_allows
) -> list[Candidate]:
    """The search space of one problem on one device kind: on a card every
    legal ``cuda`` knob value and ``library``; on the host ``ref`` and
    ``library``.  ``backends`` restricts the set."""
    def want(b):
        return backends is None or b in backends

    cands = []
    if is_gpu(device_kind):
        if want("cuda"):
            cands += [c for c in cuda_candidates(prob) if allowed(prob, c)]
    elif want("ref"):
        cands.append(Candidate("ref"))
    if want("library"):
        cands.append(Candidate("library"))
    return cands
