"""Layer-facing conv1d ops (counterpart of ``repro/kernels/ops.py``,
single device).

``conv1d`` pads for VALID / SAME / CAUSAL and runs the fused forward
``act(conv + bias + residual)`` on one of four backends:

  * ``"cuda"`` — the hand-written kernels (``conv1d_brgemm``); the default
    for a CUDA tensor.  On a CPU tensor it raises.
  * ``"ref"``  — the plain PyTorch version (``ref.conv1d_fused_ref``),
    differentiated by autograd; the default for a CPU tensor.
  * ``"library"`` — cuDNN on the card (oneDNN on the host): ``F.conv1d``
    with the epilogue as PyTorch ops, its gradients through
    ``torch.nn.grad.conv1d_input`` / ``conv1d_weight``; the counterpart
    of the JAX package's ``"xla"``, and like it computed in fp32 for
    either dtype (bf16 operands are widened, the epilogue applied to the
    fp32 sum, the result rounded once).  It runs with cuDNN's TF32 off
    (fp32 stays fp32) and its deterministic algorithms (two calls give
    the same bits, as the kernels do).  Nothing selects it by default.
  * ``"auto"`` — the tuner's plan (``repro_torch.tune.get_plan``) for
    each of the three passes: a backend and the pass's knob (the
    forward kernel's register tile, the weight gradient's body).  The
    plan of one (shape, dtype, padding, epilogue, device) is resolved
    once per process and kept in ``tune.cache.PLANS``; a miss with
    measurement off is the default (``"cuda"`` with the kernel's own tile
    on a card, ``"ref"`` on the CPU).

``REPRO_CONV_BACKEND``, read when the module is imported, names the
backend of a call that names none.
Nothing falls back from one backend to another.  The kernels mask their
own ragged width edge, so there is no round-up of the width to a tile.
``tile=`` pins the forward kernel's register tile, ``bwd_data_cfg=`` and
``bwd_weight_cfg=`` (a :class:`PassConfig`) pin a backward pass: the
knobs the tuner times and ``"auto"`` resolves.

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

import os
from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F

from . import conv1d_brgemm as _k
from . import epilogue as _ep
from . import ref as _ref

Padding = Literal["VALID", "SAME", "CAUSAL"]
BACKENDS = ("cuda", "ref", "library", "auto")
ENV_BACKEND = "REPRO_CONV_BACKEND"
# read once, when the module is imported: a call that names no backend
# pays no environment lookup
_ENV_DEFAULT = os.environ.get(ENV_BACKEND) or None


def default_backend(x: torch.Tensor) -> str:
    """``REPRO_CONV_BACKEND`` as it was when this module was imported, else
    the kernel for a CUDA tensor and the plain version for a CPU one."""
    return _ENV_DEFAULT or ("cuda" if x.is_cuda else "ref")


class PassConfig(NamedTuple):
    """How one pass runs: its backend (``"cuda"``, ``"ref"`` or
    ``"library"``) and its knob: ``tile`` for a pass of ``conv1d_fwd``
    (the forward, bwd-data), ``body`` for ``conv1d_bwd_weight``; None
    keeps the kernel's own choice."""
    backend: str = "cuda"
    tile: int | None = None
    body: str | None = None


def _as_pass_cfg(cfg) -> PassConfig | None:
    if cfg is None or isinstance(cfg, PassConfig):
        return cfg
    return PassConfig(*cfg)


def library_flags():
    """cuDNN as the ``"library"`` backend runs it: TF32 off, deterministic
    algorithms, no benchmarking."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _resolve_auto(x, *, C, K, S, dilation, padding, depthwise, epilogue):
    """``backend="auto"``: the plan of all three passes
    (``tune.get_plan``), resolved once per (cache file, device, dtype,
    shape, padding, epilogue) and kept in the process's memo
    ``tune.PLANS``."""
    from repro_torch import tune  # late import: tune.measure calls ops

    N = x.shape[0]
    Q = x.shape[-1] - (S - 1) * dilation
    key = (os.environ.get(tune.cache.ENV_CACHE_PATH), x.device, x.dtype, N,
           C, K, S, dilation, Q, padding, depthwise, epilogue)
    plan = tune.PLANS.get(key)
    if plan is None:
        got = tune.get_plan(N=N, C=C, K=K, S=S, dilation=dilation, Q=Q,
                            dtype=x.dtype, padding=padding,
                            depthwise=depthwise, epilogue=epilogue,
                            device=x.device)
        plan = tuple(PassConfig(c.backend, c.tile, c.body)
                     for c in (got[p] for p in tune.PASSES))
        tune.PLANS[key] = plan
    return plan


def _plan(backend, x, *, C, K, S, dilation, padding, depthwise, bias,
          activation, residual, tile, bwd_data_cfg, bwd_weight_cfg):
    """The (forward, bwd-data, bwd-weight) :class:`PassConfig` of a call
    that names ``"library"`` or ``"auto"`` or pins a knob: ``"auto"``'s
    plan under the pins, or the named backend on every pass that is not
    pinned."""
    bd, bw = _as_pass_cfg(bwd_data_cfg), _as_pass_cfg(bwd_weight_cfg)
    if backend == "auto":
        fwd, auto_bd, auto_bw = _resolve_auto(
            x, C=C, K=K, S=S, dilation=dilation, padding=padding,
            depthwise=depthwise,
            epilogue=_ep.signature(bias is not None, activation,
                                   residual is not None))
        _check_backend(fwd.backend, x)
        return (PassConfig(fwd.backend, tile or fwd.tile), bd or auto_bd,
                bw or auto_bw)
    return (PassConfig(backend, tile), bd or PassConfig(backend),
            bw or PassConfig(backend))


def _check_backend(backend: str, x: torch.Tensor) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; x is on "
                         f"{x.device} (use backend='ref' on the CPU)")


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
           out_dtype: torch.dtype | None = None, tile: int | None = None,
           bwd_data_cfg=None, bwd_weight_cfg=None) -> torch.Tensor:
    """1D dilated convolution with fused epilogue, paper semantics.

    x: (N, C, W), w: (S, K, C) -> (N, K, Q); Q == W for SAME/CAUSAL and
    Q = W - (S-1)*dilation for VALID.  ``y = act(conv + bias + residual)``
    on the fp32 accumulator with bias (K,) and residual (N, K, Q), stored
    in ``out_dtype`` (default x.dtype).

    ``tile`` pins the forward kernel's register tile; ``bwd_data_cfg`` /
    ``bwd_weight_cfg`` (a :class:`PassConfig` or its tuple) pin a backward
    pass, winning over ``"auto"``'s plan.

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
    _check_backend(backend, x)
    S, K, C = w.shape
    lo, hi = _pad_amounts(S, dilation, padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    backward_pinned = bwd_data_cfg is not None or bwd_weight_cfg is not None
    if backend == "ref" and not backward_pinned:
        return _ref.conv1d_fused_ref(x, w, dilation=dilation, bias=bias,
                                     activation=activation, residual=residual,
                                     out_dtype=out_dtype)
    plan = None  # the kernels with their own tiles: the default path
    if backend != "cuda" or tile is not None or backward_pinned:
        plan = _plan(backend, x, C=C, K=K, S=S, dilation=dilation,
                     padding=padding, depthwise=False, bias=bias,
                     activation=activation, residual=residual, tile=tile,
                     bwd_data_cfg=bwd_data_cfg, bwd_weight_cfg=bwd_weight_cfg)
    return fused_conv1d(x.contiguous(), w.contiguous(), bias=bias,
                        residual=residual, activation=activation,
                        dilation=dilation, out_dtype=out_dtype, plan=plan)


def fused_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 activation: str | None = None, dilation: int = 1,
                 out_dtype: torch.dtype | None = None,
                 tile: int | None = None,
                 plan: tuple[PassConfig, PassConfig, PassConfig] | None = None
                 ) -> torch.Tensor:
    """The kernel path on an already padded x (N, C, Q + (S-1)*d): through
    :class:`Conv1dFunction` when autograd records the call, else one
    launch of the forward kernel (a served call adds only the grad-mode
    check to the wrapper's host work).  ``plan`` (forward, bwd-data,
    bwd-weight :class:`PassConfig`) runs each pass on its own backend;
    ``tile`` alone pins the forward kernel's tile; with neither, the
    default, the kernels run with their own tiles.  The wrappers take the
    device from the tensors, so on CPU tensors every ``"cuda"`` pass is
    its plain version."""
    if plan is None and tile is not None:
        plan = (PassConfig("cuda", tile), PassConfig(), PassConfig())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, residual)):
        return Conv1dFunction.apply(x, w, bias, residual, dilation,
                                    _ep.canon(activation), out_dtype, plan)
    if plan is None:
        return _k.conv1d_fwd(x, w, bias=bias, residual=residual,
                             activation=activation, dilation=dilation,
                             out_dtype=out_dtype)
    return _fwd_pass(plan[0], x, w, bias=bias, residual=residual,
                     activation=activation, dilation=dilation,
                     out_dtype=out_dtype)


def _fwd_pass(cfg: PassConfig, x, w, *, save_preact: bool = False,
              bias=None, residual=None, activation=None, dilation=1,
              out_dtype=None, depthwise: bool = False):
    """The forward pass on its backend: y, or (y, fp32 pre-activation).
    Depthwise operands of two dtypes meet in fp32 (``_dw_operands``)."""
    kw = dict(activation=activation, save_preact=save_preact,
              dilation=dilation, out_dtype=out_dtype)
    if cfg.backend == "cuda" and depthwise:
        return _dw_fwd(x, w, bias=bias, residual=residual, **kw)
    if cfg.backend == "cuda":
        return _k.conv1d_fwd(x, w, bias=bias, residual=residual,
                             tile=cfg.tile, **kw)
    if depthwise:
        x, w, bias, residual = _dw_operands(x, w, bias, residual)
    if cfg.backend == "library":
        xf, wf = x.float(), w.float()
        with library_flags():
            u = (F.conv1d(xf, wf.t()[:, None, :], dilation=dilation,
                          groups=x.shape[1]) if depthwise
                 else F.conv1d(xf, wf.permute(1, 2, 0), dilation=dilation))
        u = _ep.apply_ref(u, bias=bias, residual=residual)
    elif cfg.backend == "ref":
        u = (_ref.depthwise_conv1d_preact_ref if depthwise
             else _ref.conv1d_preact_ref)(x, w, dilation=dilation, bias=bias,
                                          residual=residual)
    else:
        raise ValueError(f"unknown pass backend {cfg.backend!r}")
    y = _ep.ACTIVATIONS[_ep.canon(activation)](u).to(out_dtype or x.dtype)
    return (y, u) if save_preact else y


def _bwd_data_pass(cfg: PassConfig, du, w, *, x_shape, dilation: int,
                   out_dtype: torch.dtype, depthwise: bool = False):
    """dx on the pass's backend, in ``out_dtype``: the forward kernel on du
    padded by the span on both sides against the flipped taps (transposed
    to (S, C, K) unless depthwise); the plain version of the same; or
    ``torch.nn.grad.conv1d_input``.  du and w share a dtype."""
    S = w.shape[0]
    span = (S - 1) * dilation
    if cfg.backend == "cuda":
        du_pad = F.pad(du, (span, span))
        if depthwise:
            return _k.depthwise_conv1d_fwd(du_pad, w.flip(0).contiguous(),
                                           dilation=dilation,
                                           out_dtype=out_dtype)
        return _k.conv1d_fwd(du_pad, w.flip(0).transpose(1, 2).contiguous(),
                             dilation=dilation, out_dtype=out_dtype,
                             tile=cfg.tile)
    if cfg.backend == "library":
        wf = w.float()
        with library_flags():
            dx = torch.nn.grad.conv1d_input(
                x_shape, wf.t()[:, None, :] if depthwise
                else wf.permute(1, 2, 0), du.float(), dilation=dilation,
                groups=x_shape[1] if depthwise else 1)
        return dx.to(out_dtype)
    if cfg.backend == "ref":
        if depthwise:
            return _ref.depthwise_conv1d_bwd_data_ref(
                du, w, dilation=dilation, out_dtype=out_dtype)
        return _ref.conv1d_bwd_data_ref(du, w, dilation=dilation).to(
            out_dtype)
    raise ValueError(f"unknown pass backend {cfg.backend!r}")


def _bwd_weight_pass(cfg: PassConfig, x, du, *, S: int, dilation: int,
                     with_dbias: bool, depthwise: bool = False):
    """dw (fp32), or (dw, dbias), on the pass's backend (the depthwise
    kernel, which reads x and du each in its own dtype, is called by
    :class:`DepthwiseConv1dFunction` itself)."""
    if cfg.backend == "cuda" and not depthwise:
        return _k.conv1d_bwd_weight(x, du, S=S, dilation=dilation,
                                    with_dbias=with_dbias, body=cfg.body)
    if cfg.backend == "library":
        C, K = x.shape[1], du.shape[1]
        with library_flags():
            dw = torch.nn.grad.conv1d_weight(
                x.float(), (C, 1, S) if depthwise else (K, C, S),
                du.float(), dilation=dilation, groups=C if depthwise else 1)
        dw = dw[:, 0, :].t() if depthwise else dw.permute(2, 0, 1)
    elif cfg.backend == "ref":
        dw = (_ref.depthwise_conv1d_bwd_weight_ref if depthwise
              else _ref.conv1d_bwd_weight_ref)(x, du, dilation=dilation)
    else:
        raise ValueError(f"unknown pass backend {cfg.backend!r}")
    return (dw, _ref.conv1d_dbias_ref(du)) if with_dbias else dw


def _widest(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """One dtype for a kernel call on two operands: theirs when they
    agree, else fp32 (widening bf16 is exact)."""
    return a if a == b else torch.float32


class Conv1dFunction(torch.autograd.Function):
    """``act(conv(x, w) + bias + residual)`` on a padded x with its
    gradient (single device; no gradient all-reduce).

    ``plan`` runs each pass on its own backend (:class:`PassConfig`; None:
    the kernels with their own tiles): ``"cuda"`` the kernels, ``"ref"``
    the plain versions, ``"library"`` ``F.conv1d`` and ``torch.nn.grad``.

    The forward saves ``(x, w, saved)``: saved is nothing for a linear
    epilogue, the output for relu (its mask) and the fp32
    pre-activation for gelu/silu, which is only then asked for.  The
    backward computes

      * du = act'(.) * dy in dy's dtype (``epilogue.cotangent``);
      * dx through the forward conv on du zero-padded by the span on
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
    def forward(ctx, x, w, bias, residual, dilation, activation, out_dtype,
                plan=None):
        ctx.plan = plan
        kw = dict(bias=bias, residual=residual, activation=activation,
                  dilation=dilation, out_dtype=out_dtype)
        preact = _ep.needs_preact(activation)
        out = (_k.conv1d_fwd(x, w, save_preact=preact, **kw) if plan is None
               else _fwd_pass(plan[0], x, w, save_preact=preact, **kw))
        y, saved = out if preact else (
            out, out if activation == "relu" else None)
        ctx.save_for_backward(x, w, saved)
        ctx.dilation, ctx.activation = dilation, activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.residual_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, saved = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        d, plan = ctx.dilation, ctx.plan
        S = w.shape[0]
        span = (S - 1) * d
        du = _ep.cotangent(ctx.activation, saved, gy).contiguous()
        dx = dw = dbias = dres = None
        if need_x:
            dt = _widest(du.dtype, w.dtype)
            if plan is None:
                dx = _k.conv1d_fwd(
                    F.pad(du.to(dt), (span, span)),
                    w.flip(0).transpose(1, 2).to(dt).contiguous(),
                    dilation=d, out_dtype=x.dtype)
            else:
                dx = _bwd_data_pass(plan[1], du.to(dt), w.to(dt),
                                    x_shape=x.shape, dilation=d,
                                    out_dtype=x.dtype)
        if need_w or need_b:
            dt = _widest(x.dtype, du.dtype)
            if plan is None:
                out = _k.conv1d_bwd_weight(x.to(dt), du.to(dt), S=S,
                                           dilation=d, with_dbias=need_b)
            else:
                out = _bwd_weight_pass(plan[2], x.to(dt), du.to(dt), S=S,
                                       dilation=d, with_dbias=need_b)
            dw, dbias = out if need_b else (out, None)
            dw = dw.to(w.dtype) if need_w else None
            if need_b:
                dbias = dbias.to(ctx.bias_dtype)
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return dx, dw, dbias, dres, None, None, None, None


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None, dilation: int = 1,
                     padding: Padding = "CAUSAL", backend: str | None = None,
                     out_dtype: torch.dtype | None = None,
                     tile: int | None = None, bwd_data_cfg=None,
                     bwd_weight_cfg=None) -> torch.Tensor:
    """Depthwise 1D conv with fused epilogue.  x: (N, C, W), w: (S, C) ->
    (N, C, Q); bias (C,), residual (N, C, Q), the epilogue of ``conv1d``.
    Every backend follows the JAX package's dtype rule: fp32 accumulation
    and epilogue math, output in ``out_dtype`` or x's dtype, whatever the
    weights' dtype.  The backends and the pins are ``conv1d``'s; the
    depthwise kernels have no tile (``tile`` must be None).

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
    if tile is not None:
        raise ValueError("the depthwise kernels have no tile to pin")
    backend = backend or default_backend(x)
    _check_backend(backend, x)
    S, C = w.shape
    lo, hi = _pad_amounts(S, dilation, padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    backward_pinned = bwd_data_cfg is not None or bwd_weight_cfg is not None
    if backend == "ref" and not backward_pinned:
        return _ref.depthwise_conv1d_fused_ref(
            x, w, dilation=dilation, bias=bias, activation=activation,
            residual=residual, out_dtype=out_dtype)
    plan = None  # the kernels: the default path
    if backend != "cuda" or backward_pinned:
        plan = _plan(backend, x, C=C, K=C, S=S, dilation=dilation,
                     padding=padding, depthwise=True, bias=bias,
                     activation=activation, residual=residual, tile=None,
                     bwd_data_cfg=bwd_data_cfg, bwd_weight_cfg=bwd_weight_cfg)
    return fused_depthwise_conv1d(x.contiguous(), w.contiguous(), bias=bias,
                                  residual=residual, activation=activation,
                                  dilation=dilation, out_dtype=out_dtype,
                                  plan=plan)


def fused_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                           bias: torch.Tensor | None = None,
                           residual: torch.Tensor | None = None,
                           activation: str | None = None, dilation: int = 1,
                           out_dtype: torch.dtype | None = None,
                           plan: tuple[PassConfig, PassConfig,
                                       PassConfig] | None = None
                           ) -> torch.Tensor:
    """The depthwise kernel path on an already padded x (N, C, Q + (S-1)*d):
    through :class:`DepthwiseConv1dFunction` when autograd records the
    call, else one launch of the forward kernel.  ``plan`` as
    ``fused_conv1d``'s.  On CPU tensors every ``"cuda"`` pass is its
    plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, residual)):
        return DepthwiseConv1dFunction.apply(
            x, w, bias, residual, dilation, _ep.canon(activation), out_dtype,
            plan)
    kw = dict(bias=bias, residual=residual, activation=activation,
              dilation=dilation, out_dtype=out_dtype or x.dtype)
    if plan is None:
        return _dw_fwd(x, w, **kw)
    return _fwd_pass(plan[0], x, w, depthwise=True, **kw)


def _dw_fwd(x, w, *, bias=None, residual=None, **kw):
    """One depthwise forward kernel call on operands of one dtype
    (``_dw_operands``)."""
    x, w, bias, residual = _dw_operands(x, w, bias, residual)
    return _k.depthwise_conv1d_fwd(x, w, bias=bias, residual=residual, **kw)


def _dw_operands(x, w, bias, residual):
    """The depthwise operands brought to one dtype: theirs when they agree,
    else fp32 (exact; in the Mamba2 model all four share the model's
    dtype, so nothing is copied)."""
    ts = [t for t in (x, w, bias, residual) if t is not None]
    dt = ts[0].dtype if all(t.dtype == ts[0].dtype for t in ts) \
        else torch.float32
    return tuple(None if t is None else t.to(dt)
                 for t in (x, w, bias, residual))


class DepthwiseConv1dFunction(torch.autograd.Function):
    """``act(depthwise_conv(x, w) + bias + residual)`` on a padded x with
    its gradient (single device), the counterpart of the
    ``_dw_conv1d_pallas`` custom VJP; ``plan`` as :class:`Conv1dFunction`'s.

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
    def forward(ctx, x, w, bias, residual, dilation, activation, out_dtype,
                plan=None):
        ctx.plan = plan
        kw = dict(bias=bias, residual=residual, activation=activation,
                  dilation=dilation, out_dtype=out_dtype or x.dtype,
                  save_preact=_ep.needs_preact(activation))
        out = (_dw_fwd(x, w, **kw) if plan is None
               else _fwd_pass(plan[0], x, w, depthwise=True, **kw))
        y, saved = out if kw["save_preact"] else (
            out, out if activation == "relu" else None)
        ctx.save_for_backward(x, w, saved)
        ctx.dilation, ctx.activation = dilation, activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.residual_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, saved = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        d, plan = ctx.dilation, ctx.plan
        S = w.shape[0]
        span = (S - 1) * d
        du = _ep.cotangent(ctx.activation, saved, gy).contiguous()
        dx = dw = dbias = dres = None
        if need_x:
            dt = _widest(du.dtype, w.dtype)
            if plan is None:
                dx = _k.depthwise_conv1d_fwd(
                    F.pad(du.to(dt), (span, span)),
                    w.flip(0).to(dt).contiguous(), dilation=d,
                    out_dtype=x.dtype)
            else:
                dx = _bwd_data_pass(plan[1], du.to(dt), w.to(dt),
                                    x_shape=x.shape, dilation=d,
                                    out_dtype=x.dtype, depthwise=True)
        if need_w or need_b:
            if plan is None or plan[2].backend == "cuda":
                # the kernel reads x and du each in its own dtype
                out = _k.depthwise_conv1d_bwd_weight(
                    x, du, S=S, dilation=d, with_dbias=need_b)
            else:  # the library and the plain version take one
                dt = _widest(x.dtype, du.dtype)
                out = _bwd_weight_pass(plan[2], x.to(dt), du.to(dt), S=S,
                                       dilation=d, with_dbias=need_b,
                                       depthwise=True)
            dw, dbias = out if need_b else (out, None)
            dw = dw.to(w.dtype) if need_w else None
            if need_b:
                dbias = dbias.to(ctx.bias_dtype)
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return dx, dw, dbias, dres, None, None, None, None


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
