"""Epilogue vocabulary of the conv kernels: ``y = act(conv + bias + residual)``.

Counterpart of ``repro/kernels/epilogue.py``.  The activations apply to fp32
values, in the same order in the CUDA kernel's epilogue
(``csrc/conv1d_fwd.cu``) and in the plain version (``apply_ref``).  gelu is
the tanh approximation, which is what ``jax.nn.gelu`` computes by default.
``cotangent`` is the activation's derivative for the backward (JAX
``ops._epilogue_cotangent``).
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


def parse(sig: str | None) -> tuple[bool, str, bool]:
    """Inverse of ``signature``: -> (has_bias, activation, has_residual)."""
    if sig in ("", "none", None):
        return False, "none", False
    parts = sig.split("+")
    acts = [p for p in parts if p not in ("b", "r")]
    if len(acts) > 1 or any(a not in ACTIVATIONS for a in acts):
        raise ValueError(f"bad epilogue signature {sig!r}")
    return "b" in parts, acts[0] if acts else "none", "r" in parts


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


def needs_preact(activation: str | None) -> bool:
    """relu's gradient mask comes from the output it already stored; only
    the curved activations (gelu, silu) need the fp32 pre-activation saved
    as the kernel's second output."""
    return canon(activation) not in ("none", "relu")


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of the tanh-form gelu ``u * 0.5 * (1 + tanh(k0 (u + k1 u^3)))``."""
    k0, k1 = 0.7978845608028654, 0.044715
    t = torch.tanh(k0 * (u + k1 * u * u * u))
    return 0.5 * (1 + t) + 0.5 * u * (1 - t * t) * k0 * (1 + 3 * k1 * u * u)


def _silu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of ``u * sigmoid(u)``."""
    sig = torch.sigmoid(u)
    return sig * (1 + u * (1 - sig))


_GRADS = {"gelu": _gelu_grad, "silu": _silu_grad}


def cotangent(activation: str | None, saved: torch.Tensor | None,
              gout: torch.Tensor) -> torch.Tensor:
    """``du = act'(u) * gout`` elementwise, in gout's dtype.  ``saved`` is
    what the forward kept for it: nothing for a linear epilogue, the
    output for relu (masked where it is not > 0), the fp32 pre-activation
    for gelu and silu (derivative in fp32, then one cast)."""
    act = canon(activation)
    if act == "none":
        return gout
    if act == "relu":
        return torch.where(saved > 0, gout, torch.zeros_like(gout))
    return (_GRADS[act](saved) * gout.float()).to(gout.dtype)
