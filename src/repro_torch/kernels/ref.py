"""Plain PyTorch versions of the conv kernels (counterpart of
``repro/kernels/ref.py``).

These are what the CUDA kernels are held against, on the card by
``chip_smoke.py`` and on the CPU by the tests, and what a wrapper computes
for a tensor that lies on the CPU.

Conventions (the paper's layout, kept from the JAX package):
  x   : (N, C, W)   input
  w   : (S, K, C)   weights in the paper's forward layout (not torch's
                    (K, C, S))
  out : (N, K, Q)   Q = W - (S - 1) * dilation   (VALID on pre-padded input)
"""
from __future__ import annotations

import torch

from . import epilogue as _ep


def _conv1d_f32(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The paper's Algorithm 1 in fp32 with no output cast: S GEMMs over
    width-shifted slices of the input, accumulated tap by tap."""
    S, K, C = w.shape
    N, Cx, W = x.shape
    if C != Cx:
        raise ValueError(f"weight has C={C} but input has C={Cx}")
    Q = W - (S - 1) * dilation
    if Q <= 0:
        raise ValueError(f"width {W} too small for S={S}, dilation={dilation}")
    xf, wf = x.float(), w.float()
    out = torch.zeros((N, K, Q), dtype=torch.float32, device=x.device)
    for s in range(S):
        xs = xf[:, :, s * dilation:s * dilation + Q]
        out = out + torch.einsum("kc,ncq->nkq", wf[s], xs)
    return out


def conv1d_ref(x: torch.Tensor, w: torch.Tensor, *,
               dilation: int = 1) -> torch.Tensor:
    """Eq. (2) of the paper: Out[k,q] = sum_{c,s} In[c, q+d*s] W[s,k,c]."""
    return _conv1d_f32(x, w, dilation).to(x.dtype)


def conv1d_fused_ref(x: torch.Tensor, w: torch.Tensor, *, dilation: int = 1,
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The fused-epilogue forward: act(conv + bias + residual) with all the
    epilogue math on the fp32 accumulator, then one cast to ``out_dtype``
    (default ``x.dtype``)."""
    u = _ep.apply_ref(_conv1d_f32(x, w, dilation), bias=bias,
                      residual=residual, activation=activation)
    return u.to(out_dtype or x.dtype)
