"""Layer-facing conv1d ops (counterpart of ``repro/kernels/ops.py``,
single device).

``conv1d`` pads for VALID / SAME / CAUSAL and runs the fused forward
``act(conv + bias + residual)`` on one of two backends:

  * ``"cuda"`` — the hand-written kernels (``conv1d_brgemm``); the default
    for a CUDA tensor.  On a CPU tensor it raises.
  * ``"ref"``  — the plain PyTorch version (``ref.conv1d_fused_ref``),
    differentiated by autograd; the default for a CPU tensor.

Nothing falls back from one to the other.  The kernels mask their own
ragged width edge, so there is no round-up of the width to a tile.

On the ``"cuda"`` backend a call that autograd records (grad mode on and
an input that requires grad) goes through :class:`Conv1dFunction`, the
counterpart of the ``_conv1d_pallas`` custom VJP: the forward kernel, then
in the backward the activation's derivative, the data gradient through the
forward kernel (Alg. 3) and the weight and bias gradients through
``conv1d_bwd_weight`` (Alg. 4).  Any other call (serving, under
``inference_mode``) launches the forward kernel directly.  The padding
stays outside the Function, as ``jnp.pad`` sits outside the custom VJP, so
autograd slices the data gradient back to the unpadded input.

``depthwise_conv1d`` is the same for the depthwise (C == K) conv of the
Mamba2 block, weights ``(S, C)``: on ``"cuda"`` it runs
``depthwise_conv1d_fwd`` and, when autograd records the call,
:class:`DepthwiseConv1dFunction` (the ``_dw_conv1d_pallas`` custom VJP).

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
    S = w.shape[0]
    lo, hi = _pad_amounts(S, dilation, padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    if backend == "ref":
        return _ref.conv1d_fused_ref(x, w, dilation=dilation, bias=bias,
                                     activation=activation, residual=residual,
                                     out_dtype=out_dtype)
    return fused_conv1d(x.contiguous(), w.contiguous(), bias=bias,
                        residual=residual, activation=activation,
                        dilation=dilation, out_dtype=out_dtype)


def fused_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 activation: str | None = None, dilation: int = 1,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel path on an already padded x (N, C, Q + (S-1)*d): through
    :class:`Conv1dFunction` when autograd records the call, else one
    launch of the forward kernel (a served call adds only the grad-mode
    check to the wrapper's host work).  The wrappers take the device from
    the tensors, so on CPU tensors every pass is its plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, residual)):
        return Conv1dFunction.apply(x, w, bias, residual, dilation,
                                    _ep.canon(activation), out_dtype)
    return _k.conv1d_fwd(x, w, bias=bias, residual=residual,
                         activation=activation, dilation=dilation,
                         out_dtype=out_dtype)


def _widest(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """One dtype for a kernel call on two operands: theirs when they
    agree, else fp32 (widening bf16 is exact)."""
    return a if a == b else torch.float32


class Conv1dFunction(torch.autograd.Function):
    """``act(conv(x, w) + bias + residual)`` on a padded x with its
    gradient (single device; no gradient all-reduce).

    The forward saves ``(x, w, saved)``: saved is nothing for a linear
    epilogue, the output for relu (its mask) and the kernel's fp32
    pre-activation for gelu/silu, which is only then asked for.  The
    backward computes

      * du = act'(.) * dy in dy's dtype (``epilogue.cotangent``);
      * dx through the forward kernel on du zero-padded by the span on
        both sides against ``w.flip(0).transpose(1, 2)``, (S, C, K),
        stored in x's dtype; skipped when no one wants dx (the stem's
        input is data);
      * (dw, dbias) through ``conv1d_bwd_weight``, cast to w's and the
        bias's dtypes;
      * dresidual = du in the residual's dtype.

    Each kernel call takes one dtype.  Where the operands differ (the
    bf16 model's heads give an fp32 cotangent against bf16 weights and
    inputs), the bf16 operand is widened to fp32, which is exact and is
    what the reference's fp32 accumulation computes.
    """

    @staticmethod
    def forward(ctx, x, w, bias, residual, dilation, activation, out_dtype):
        kw = dict(bias=bias, residual=residual, activation=activation,
                  dilation=dilation, out_dtype=out_dtype)
        if _ep.needs_preact(activation):
            y, saved = _k.conv1d_fwd(x, w, save_preact=True, **kw)
        else:
            y = _k.conv1d_fwd(x, w, **kw)
            saved = y if activation == "relu" else None
        ctx.save_for_backward(x, w, saved)
        ctx.dilation, ctx.activation = dilation, activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.residual_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, saved = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        d = ctx.dilation
        S = w.shape[0]
        span = (S - 1) * d
        du = _ep.cotangent(ctx.activation, saved, gy).contiguous()
        dx = dw = dbias = dres = None
        if need_x:
            dt = _widest(du.dtype, w.dtype)
            dx = _k.conv1d_fwd(
                F.pad(du.to(dt), (span, span)),
                w.flip(0).transpose(1, 2).to(dt).contiguous(),
                dilation=d, out_dtype=x.dtype)
        if need_w or need_b:
            dt = _widest(x.dtype, du.dtype)
            out = _k.conv1d_bwd_weight(x.to(dt), du.to(dt), S=S, dilation=d,
                                       with_dbias=need_b)
            dw, dbias = out if need_b else (out, None)
            dw = dw.to(w.dtype) if need_w else None
            if need_b:
                dbias = dbias.to(ctx.bias_dtype)
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return dx, dw, dbias, dres, None, None, None


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None, dilation: int = 1,
                     padding: Padding = "CAUSAL", backend: str | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Depthwise 1D conv with fused epilogue.  x: (N, C, W), w: (S, C) ->
    (N, C, Q); bias (C,), residual (N, C, Q), the epilogue of ``conv1d``.
    Both backends follow the JAX package's dtype rule: fp32 accumulation
    and epilogue math, output in ``out_dtype`` or x's dtype, whatever the
    weights' dtype.

    Example (CPU, the plain version; the Mamba2 causal conv)::

        >>> import torch
        >>> from repro_torch.kernels import ops
        >>> x, w = torch.ones(2, 16, 64), torch.ones(4, 16)
        >>> ops.depthwise_conv1d(x, w, padding="CAUSAL").shape
        torch.Size([2, 16, 64])
        >>> ops.depthwise_conv1d(x, w, bias=torch.zeros(16),
        ...                      activation="silu").shape
        torch.Size([2, 16, 64])
    """
    backend = backend or default_backend(x)
    if backend not in BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; x is on "
                         f"{x.device} (use backend='ref' on the CPU)")
    lo, hi = _pad_amounts(w.shape[0], dilation, padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    if backend == "ref":
        return _ref.depthwise_conv1d_fused_ref(
            x, w, dilation=dilation, bias=bias, activation=activation,
            residual=residual, out_dtype=out_dtype)
    return fused_depthwise_conv1d(x.contiguous(), w.contiguous(), bias=bias,
                                  residual=residual, activation=activation,
                                  dilation=dilation, out_dtype=out_dtype)


def fused_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                           bias: torch.Tensor | None = None,
                           residual: torch.Tensor | None = None,
                           activation: str | None = None, dilation: int = 1,
                           out_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """The depthwise kernel path on an already padded x (N, C, Q + (S-1)*d):
    through :class:`DepthwiseConv1dFunction` when autograd records the
    call, else one launch of the forward kernel.  On CPU tensors every
    pass is its plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, residual)):
        return DepthwiseConv1dFunction.apply(
            x, w, bias, residual, dilation, _ep.canon(activation), out_dtype)
    return _dw_fwd(x, w, bias, residual, activation=activation,
                   dilation=dilation, out_dtype=out_dtype or x.dtype)


def _dw_fwd(x, w, bias, residual, **kw):
    """One forward kernel call on operands brought to one dtype: theirs
    when they agree, else fp32 (exact; in the Mamba2 model all four share
    the model's dtype, so nothing is copied)."""
    ts = [t for t in (x, w, bias, residual) if t is not None]
    dt = ts[0].dtype if all(t.dtype == ts[0].dtype for t in ts) \
        else torch.float32

    def cast(t):
        return None if t is None else t.to(dt)

    return _k.depthwise_conv1d_fwd(cast(x), cast(w), bias=cast(bias),
                                   residual=cast(residual), **kw)


class DepthwiseConv1dFunction(torch.autograd.Function):
    """``act(depthwise_conv(x, w) + bias + residual)`` on a padded x with
    its gradient (single device), the counterpart of the
    ``_dw_conv1d_pallas`` custom VJP.

    The forward saves ``(x, w, saved)`` as :class:`Conv1dFunction` does
    (the fp32 pre-activation only for gelu/silu).  The backward computes

      * du = act'(.) * dy in dy's dtype (``epilogue.cotangent``);
      * dx through the forward kernel on du zero-padded by the span on
        both sides against ``w.flip(0)`` (no transpose: depthwise), stored
        in x's dtype.  The tiny (S, C) weights are widened to du's fp32,
        never the cotangent rounded;
      * (dw, dbias) through ``depthwise_conv1d_bwd_weight``, which reads x
        and du each in its own dtype (no fp32 copy of a bf16 x), cast to
        w's and the bias's dtypes;
      * dresidual = du in the residual's dtype.
    """

    @staticmethod
    def forward(ctx, x, w, bias, residual, dilation, activation, out_dtype):
        kw = dict(activation=activation, dilation=dilation,
                  out_dtype=out_dtype or x.dtype)
        if _ep.needs_preact(activation):
            y, saved = _dw_fwd(x, w, bias, residual, save_preact=True, **kw)
        else:
            y = _dw_fwd(x, w, bias, residual, **kw)
            saved = y if activation == "relu" else None
        ctx.save_for_backward(x, w, saved)
        ctx.dilation, ctx.activation = dilation, activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.residual_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, saved = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        d = ctx.dilation
        S = w.shape[0]
        span = (S - 1) * d
        du = _ep.cotangent(ctx.activation, saved, gy).contiguous()
        dx = dw = dbias = dres = None
        if need_x:
            dt = _widest(du.dtype, w.dtype)
            dx = _k.depthwise_conv1d_fwd(
                F.pad(du.to(dt), (span, span)), w.flip(0).to(dt).contiguous(),
                dilation=d, out_dtype=x.dtype)
        if need_w or need_b:
            out = _k.depthwise_conv1d_bwd_weight(x, du, S=S, dilation=d,
                                                 with_dbias=need_b)
            dw, dbias = out if need_b else (out, None)
            dw = dw.to(w.dtype) if need_w else None
            if need_b:
                dbias = dbias.to(ctx.bias_dtype)
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return dx, dw, dbias, dres, None, None, None


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
