"""Epilogue vocabulary of the conv kernels: ``y = act(conv + bias + residual)``.

Counterpart of ``repro/kernels/epilogue.py``.  The activations apply to fp32
values, in the same order in the CUDA kernel's epilogue
(``csrc/conv1d_fwd.cu``) and in the plain version (``apply_ref``).  gelu is
the tanh approximation, which is what ``jax.nn.gelu`` computes by default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "none": lambda u: u,
    "relu": torch.relu,
    "gelu": lambda u: F.gelu(u, approximate="tanh"),
    "silu": F.silu,
}

# The kernel's integer code for each activation (``ACT_*`` in conv1d_fwd.cu).
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}


def canon(activation: str | None) -> str:
    """Normalise an activation spec to an ``ACTIVATIONS`` key."""
    act = "none" if activation is None else str(activation).lower()
    if act not in ACTIVATIONS:
        raise ValueError(
            f"unknown epilogue activation {activation!r}; "
            f"expected one of {sorted(ACTIVATIONS)}")
    return act


def signature(has_bias: bool, activation: str | None,
              has_residual: bool) -> str:
    """Canonical epilogue signature, e.g. ``'b+relu+r'`` (``'none'`` when
    nothing is fused)."""
    act = canon(activation)
    parts = ([*("b",) * has_bias]
             + ([act] if act != "none" else [])
             + [*("r",) * has_residual])
    return "+".join(parts) if parts else "none"


def apply_ref(u: torch.Tensor, *, bias: torch.Tensor | None = None,
              residual: torch.Tensor | None = None,
              activation: str | None = None) -> torch.Tensor:
    """Plain epilogue: fp32 math in the kernel's order, fp32 result.

    u: (N, K, Q) conv output; bias: (K,); residual: (N, K, Q).  The caller
    casts to the output dtype, as the kernel casts only at its store.
    """
    u = u.float()
    if bias is not None:
        u = u + bias.float()[None, :, None]
    if residual is not None:
        u = u + residual.float()
    return ACTIVATIONS[canon(activation)](u)
