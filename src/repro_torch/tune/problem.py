"""ConvProblem — the descriptor every layer of the tuner speaks
(counterpart of ``repro/tune/problem.py``).

A ``ConvProblem`` is one pass of one conv1d layer instance:

    pass_ ∈ {fwd, bwd_data, bwd_weight}
        × (N, C, K, S, dilation, Q) × dtype × padding × depthwise
        × epilogue signature

``C``/``K``/``Q`` are always the forward layer's numbers; the derived
views give the GEMM each pass runs.  ``bwd_data`` is the forward kernel on
the padded cotangent against the flipped, transposed ``(S, C, K)``
weights: it contracts over K, produces C filter rows, and its output is
the input width ``Q + (S-1)·d``.  ``bwd_weight`` has no filter tile on
the dense path.  The epilogue operands ride only the forward kernel
(``pass_epilogue``), but the signature stays in every pass's key: it
changes what the backward computes.

``key()`` renders the cache key exactly as the JAX package does for the
same device-kind string: the forward keeps the untagged form, a backward
pass appends ``|pass:``.  The JAX package's search constraints ``alg``,
``nblk`` and ``pipe`` have no axis on this card's kernels and are not
fields here (its keys carry them only when set); ``localized``, the
per-shard view, waits for the sharded launchers.
"""
from __future__ import annotations

import dataclasses

import torch

from .cache import cache_key

PASS_FWD = "fwd"
PASS_BWD_DATA = "bwd_data"
PASS_BWD_WEIGHT = "bwd_weight"
PASSES = (PASS_FWD, PASS_BWD_DATA, PASS_BWD_WEIGHT)


def dtype_name(dtype) -> str:
    """'float32' / 'bfloat16' from a torch dtype or a name."""
    name = str(dtype).removeprefix("torch.")
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return name


@dataclasses.dataclass(frozen=True)
class ConvProblem:
    """One pass of one conv1d layer instance, in forward-layer coordinates."""

    N: int
    C: int
    K: int
    S: int
    dilation: int
    Q: int
    dtype: str                   # 'float32' | 'bfloat16'
    padding: str = "VALID"
    depthwise: bool = False
    epilogue: str = "none"       # repro_torch.kernels.epilogue.signature
    pass_: str = PASS_FWD

    def __post_init__(self):
        if self.pass_ not in PASSES:
            raise ValueError(f"unknown pass {self.pass_!r}; expected {PASSES}")
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    # -- derived views of the GEMM this pass runs ---------------------------

    @property
    def span(self) -> int:
        return (self.S - 1) * self.dilation

    @property
    def dtype_bytes(self) -> int:
        return getattr(torch, self.dtype).itemsize

    @property
    def q_out(self) -> int:
        """Output width of the pass's kernel (bwd-data is one span wider)."""
        return self.Q + self.span if self.pass_ == PASS_BWD_DATA else self.Q

    @property
    def contraction(self) -> int:
        """Channel rows the pass's kernel reads: K for bwd-data's
        transposed GEMM, C otherwise."""
        if self.depthwise:
            return self.C
        return self.K if self.pass_ == PASS_BWD_DATA else self.C

    @property
    def n_filters(self) -> int:
        """Output rows of the pass's GEMM (bwd-data produces dx's C rows)."""
        if self.depthwise:
            return self.C
        return self.C if self.pass_ == PASS_BWD_DATA else self.K

    @property
    def pass_epilogue(self) -> str:
        """Epilogue operands the pass's kernel stages (forward only)."""
        return self.epilogue if self.pass_ == PASS_FWD else "none"

    # -- identity -----------------------------------------------------------

    def with_pass(self, pass_: str) -> "ConvProblem":
        return dataclasses.replace(self, pass_=pass_)

    def key(self, device_kind: str) -> str:
        return cache_key(device_kind=device_kind, dtype=self.dtype, N=self.N,
                         C=self.C, K=self.K, S=self.S, dilation=self.dilation,
                         Q=self.Q, padding=self.padding,
                         depthwise=self.depthwise, epilogue=self.epilogue,
                         pass_=self.pass_)
