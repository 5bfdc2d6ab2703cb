"""DilatedConv1D — the paper's layer as an ``nn.Module`` (counterpart of
``repro/core/conv1d.py``).

Parameters keep the paper's forward layout: ``w`` is (S, K, C) with init
``N(0, 1) * (C*S)^-1/2``, and ``b`` is (K,) zeros.  Bias, activation and
residual are the kernel's fused epilogue, not separate ops.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops


class DilatedConv1D(nn.Module):
    def __init__(self, c_in: int, c_out: int, filter_width: int, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        fan_in = c_in * filter_width
        # drawn on the CPU so a seeded generator gives the same weights on
        # every device
        w = (torch.randn((filter_width, c_out, c_in), generator=generator,
                         dtype=torch.float32) * fan_in ** -0.5)
        self.w = nn.Parameter(w.to(device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(c_out, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, *, dilation: int = 1,
                padding: kops.Padding = "SAME", backend: str | None = None,
                activation: str | None = None,
                residual: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None,
                tile: int | None = None) -> torch.Tensor:
        """x: (N, C_in, W) -> (N, C_out, Q): ``act(conv(x) + b + residual)``
        in one fused kernel call.  ``backend="auto"`` (or
        ``REPRO_CONV_BACKEND=auto``) runs the tuner's plan for each pass;
        ``tile`` pins the forward kernel's register tile."""
        return kops.conv1d(x, self.w, bias=self.b, activation=activation,
                           residual=residual, dilation=dilation,
                           padding=padding, backend=backend,
                           out_dtype=out_dtype, tile=tile)
