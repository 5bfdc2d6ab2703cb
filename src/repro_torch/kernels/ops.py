"""Layer-facing conv1d ops (counterpart of ``repro/kernels/ops.py``, forward
only).

``conv1d`` pads for VALID / SAME / CAUSAL and runs the fused forward
``act(conv + bias + residual)`` on one of two backends:

  * ``"cuda"`` — the hand-written kernel (``conv1d_brgemm.conv1d_fwd``);
    the default for a CUDA tensor.  On a CPU tensor it raises.
  * ``"ref"``  — the plain PyTorch version (``ref.conv1d_fused_ref``); the
    default for a CPU tensor.

Nothing falls back from one to the other.  The kernel masks its own ragged
width edge, so there is no round-up of the width to a tile.

``conv1d_streaming`` is the causal streaming step: one VALID pass over
``state ++ chunk`` and the carried state slid to the last ``(S-1)*d``
input columns.
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from . import conv1d_brgemm as _k
from . import epilogue as _ep
from . import ref as _ref

Padding = Literal["VALID", "SAME", "CAUSAL"]
BACKENDS = ("cuda", "ref")


def default_backend(x: torch.Tensor) -> str:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    return "cuda" if x.is_cuda else "ref"


def _pad_amounts(S: int, dilation: int, padding: Padding) -> tuple[int, int]:
    span = (S - 1) * dilation
    if padding == "VALID":
        return 0, 0
    if padding == "SAME":
        return span // 2, span - span // 2
    if padding == "CAUSAL":
        return span, 0
    raise ValueError(f"unknown padding {padding!r}")


def conv1d(x: torch.Tensor, w: torch.Tensor, *,
           bias: torch.Tensor | None = None, activation: str | None = None,
           residual: torch.Tensor | None = None, dilation: int = 1,
           padding: Padding = "SAME", backend: str | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """1D dilated convolution with fused epilogue, paper semantics.

    x: (N, C, W), w: (S, K, C) -> (N, K, Q); Q == W for SAME/CAUSAL and
    Q = W - (S-1)*dilation for VALID.  ``y = act(conv + bias + residual)``
    on the fp32 accumulator with bias (K,) and residual (N, K, Q), stored
    in ``out_dtype`` (default x.dtype).

    Example (CPU, the plain version)::

        >>> import torch
        >>> from repro_torch.kernels import ops
        >>> x, w = torch.ones(2, 8, 64), torch.ones(3, 4, 8)
        >>> ops.conv1d(x, w, dilation=2, padding="SAME").shape
        torch.Size([2, 4, 64])
        >>> ops.conv1d(x, w, dilation=2, padding="VALID").shape
        torch.Size([2, 4, 60])
    """
    backend = backend or default_backend(x)
    if backend not in BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; x is on "
                         f"{x.device} (use backend='ref' on the CPU)")
    activation = _ep.canon(activation)
    S = w.shape[0]
    lo, hi = _pad_amounts(S, dilation, padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    if backend == "ref":
        return _ref.conv1d_fused_ref(x, w, dilation=dilation, bias=bias,
                                     activation=activation, residual=residual,
                                     out_dtype=out_dtype)
    return _k.conv1d_fwd(x.contiguous(), w.contiguous(), bias=bias,
                         residual=residual, activation=activation,
                         dilation=dilation, out_dtype=out_dtype)


def conv_stream_state(batch: int, c_in: int, S: int, dilation: int,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Fresh per-layer streaming state ``(batch, c_in, (S-1)*dilation)``: the
    input columns the causal conv reaches back over, zeros while there is
    no history (zeros are the CAUSAL left padding)."""
    return torch.zeros((batch, c_in, (S - 1) * dilation), dtype=dtype,
                       device=device)


def conv1d_streaming(x: torch.Tensor, w: torch.Tensor, *,
                     state: torch.Tensor, bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None, dilation: int = 1,
                     backend: str | None = None,
                     out_dtype: torch.dtype | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of a causal dilated conv1d.

    x: (N, C, W_chunk) new columns; ``state`` from :func:`conv_stream_state`
    or the previous step.  Returns ``(y, new_state)``, y (N, K, W_chunk)
    being the same columns of a one-shot ``conv1d(full_x, w,
    padding="CAUSAL")``: ONE VALID pass over ``[state | chunk]``, nothing of
    the history recomputed.  ``new_state`` is a dense copy of the last
    ``(S-1)*d`` columns, so it does not pin the whole window.
    """
    S, K, C = w.shape
    span = (S - 1) * dilation
    N, Cx, W = x.shape
    if tuple(state.shape) != (N, Cx, span):
        raise ValueError(f"streaming state shape {tuple(state.shape)} does "
                         f"not match (N={N}, C_in={Cx}, span={span})")
    if state.dtype != x.dtype:
        raise ValueError(f"streaming state dtype {state.dtype} != chunk "
                         f"dtype {x.dtype}; init the state with the stream's "
                         "input dtype")
    xc = torch.cat([state, x], dim=-1) if span else x
    y = conv1d(xc, w, bias=bias, activation=activation, residual=residual,
               dilation=dilation, padding="VALID", backend=backend,
               out_dtype=out_dtype)
    return y, xc[:, :, xc.shape[-1] - span:].contiguous()
