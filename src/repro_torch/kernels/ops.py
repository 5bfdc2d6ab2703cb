"""Layer-facing conv1d ops (counterpart of ``repro/kernels/ops.py``).

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

``conv1d_streaming`` and ``depthwise_conv1d_streaming`` are the causal
streaming steps: one VALID pass over ``state ++ chunk`` and the carried
state slid to the last ``(S-1)*d`` input columns.

**Data parallelism** (``grad_reduce``, the JAX package's
``grad_reduce_axes``): a process group, or a per-step
``reduce.GradReducer`` over one, marks the call as running on one
rank's share of the batch.  Each Function's backward then sums (dw,
dbias) over the group right after its bwd-weight pass, as one all-reduce
of one fp32 buffer: with a reducer asynchronously, so that layer *l*'s
reduce can overlap the backward of layers < *l* (the reducer waits
before ``torch.autograd.grad`` returns), with a bare group at once.
``grad_reduce_chunks`` > 1 runs the bwd-weight pass over that many
contiguous width ranges instead (x sliced ``[lo, hi + span)``, du ``[lo,
hi)``, each slice copied, since the kernels take contiguous operands),
reduces each partial as soon as it exists and sums the reduced partials
in range order.  On ``"ref"``, which autograd differentiates, the weight
and the bias pass through :class:`ReduceGrad`, whose backward sums their
cotangents over the group (JAX's ``_psum_cotangent``; one reduce, no
chunks).  Without a group every reduce is the identity.

**Tensor parallelism** (``model_reduce``, the JAX package's
``model_reduce_axes``): the model group marks the call as K-sharded: w
and the bias hold this rank's K/mp filter rows, x all C channels.  The
forward and bwd-weight need no collective; bwd-data contracts over the
local K rows only, so :class:`Conv1dFunction`'s backward sums dx over the
model group right after the bwd-data pass and waits before it returns
(the layer before reads dx at once; ``reduce.ModelReducer``).  The
partial dx is computed in fp32 and rounded to x's dtype after the sum,
so a bf16 dx is rounded once, not once a rank and once more in the sum.
``model_reduce_chunks`` > 1 runs bwd-data over that many disjoint column
ranges of dx (``_chunk_ranges`` over its width Q + span; column q reads
the padded cotangent's ``[q, q + span]``, so range ``[lo, hi)`` runs the
kernel on ``du_pad[..., lo:hi + span]``, a copy, since the kernel takes
contiguous operands) and issues each range's sum as soon as the range
exists, so it can run while the next range computes.  The kernel sums
each output column in one order whatever its width or tile, and the
ranges are disjoint, so the chunked dx is bitwise the unchunked one.  On
``"ref"`` x passes through :class:`ModelReduceGrad`, whose backward sums
its cotangent over the model group (JAX's ``_model_psum_cotangent``; one
reduce, no chunks).  ``depthwise_conv1d`` refuses ``model_reduce``: under
channel groups no pass contracts over a sharded axis.

**Telemetry** (``repro_torch.obs``, the JAX package's ``_obs_conv``):
with a sink open, every pass of every call is a ``conv1d.<pass>`` span:
the forward (the Function's, a no-grad call's or the plain version's),
bwd-data around the whole data gradient with its model sums and column
ranges, and bwd-weight around the weight and bias gradients up to the
issue of their reduces (one span a layer, whatever
``grad_reduce_chunks``).  Its attrs are the JAX package's cell (``N``,
``C``, ``K``, ``S``, ``dilation``, ``Q``, ``dtype`` by JAX's name,
``depthwise``), the backend and the pass's knob (``tile`` or ``body``;
None is the kernel's own), ``pipe_depth`` 0 (no pipelined kernels here),
``flops`` (JAX's counts), ``gflops_per_s`` and, on a card, ``efficiency``:
achieved FLOP/s over the peak of ``peak``, the dtype's, except the fp32
``conv1d_bwd_weight`` kernel's, which computes in TF32 tensor cores
(``tf32``).  On a card the span is timed by CUDA events
(``obs.device_span``): no host synchronize is added to a pass.  Each dx
sum over the model group also logs a ``conv.psum.model`` event (one a
call and column range; bytes summed).  Disabled, each hook is one check.
"""
from __future__ import annotations

import os
from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs

from . import conv1d_brgemm as _k
from . import epilogue as _ep
from . import ref as _ref
from .reduce import GradReducer, ModelReducer, mp_size

Padding = Literal["VALID", "SAME", "CAUSAL"]
BACKENDS = ("cuda", "ref", "library", "auto")
ENV_BACKEND = "REPRO_CONV_BACKEND"
# read once, when the module is imported: a call that names no backend
# pays no environment lookup
_ENV_DEFAULT = os.environ.get(ENV_BACKEND) or None


def default_backend(x: torch.Tensor) -> str:
    """``REPRO_CONV_BACKEND`` as it was when this module was imported, else
    the kernel for a CUDA tensor (and for a ``meta`` one, a dry-run's,
    whose wrappers report the kernel's work) and the plain version for a
    CPU one."""
    return _ENV_DEFAULT or ("cuda" if x.is_cuda or x.is_meta else "ref")


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
    if backend == "cuda" and not (x.is_cuda or x.is_meta):
        raise ValueError("backend='cuda' needs CUDA tensors; x is on "
                         f"{x.device} (use backend='ref' on the CPU)")


def _dtype_name(dtype: torch.dtype) -> str:
    """A dtype by the JAX package's name ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _conv_span(pass_: str, backend: str, x: torch.Tensor, w: torch.Tensor,
               dilation: int, depthwise: bool, knob=None):
    """The ``conv1d.<pass_>`` span of one pass of the layer of padded input
    ``x`` (N, C, W) and weights ``w``; ``knob`` is the pass's tile
    (forward, bwd-data) or body (bwd-weight).  The shared no-op span while
    telemetry is off, before anything is read or built."""
    if not _obs.enabled():
        return _obs.NOOP_SPAN
    N, C, W = x.shape
    S, K = w.shape[0], (C if depthwise else w.shape[1])
    device = x.device
    Q = W - (S - 1) * dilation
    # the JAX package's counts: bwd-data over all W input columns
    flops = 2.0 * N * C * K * S * (W if pass_ == "bwd_data" else Q)
    if depthwise:
        flops /= K
    dt = _dtype_name(x.dtype)
    peak = ("tf32" if pass_ == "bwd_weight" and backend == "cuda"
            and not depthwise and dt == "float32" else dt)

    def close(dur: float) -> dict:
        out = {"flops": flops,
               "gflops_per_s": flops / max(dur, 1e-30) / 1e9}
        if device.type == "cuda":
            from repro_torch.roofline.analysis import (
                achieved_fraction_of_peak)
            try:
                out["efficiency"] = achieved_fraction_of_peak(
                    flops, dur, torch.cuda.get_device_name(device), peak)
                out["peak"] = peak
            except ValueError:
                pass  # a card without known peaks: GFLOP/s only
        return out

    attrs = dict(backend=backend, N=N, C=C, K=K, S=S, dilation=dilation,
                 Q=Q, dtype=dt, depthwise=depthwise, pipelined=False,
                 pipe_depth=0, overlap_frac=0.0)
    if not depthwise:
        attrs["body" if pass_ == "bwd_weight" else "tile"] = knob
    return _obs.device_span(f"conv1d.{pass_}", device, close, **attrs)


def _model_psum_event(buf: torch.Tensor, group, chunk: int, chunks: int,
                      x_shape, dtype, S: int, K: int, dilation: int) -> None:
    """A ``conv.psum.model`` event for one dx sum over the model group
    (JAX's ``_model_psum_event``): the range's index and count, the
    group's size and the bytes summed, with the layer's cell (``K`` the
    rank's filter rows)."""
    if not _obs.enabled():
        return
    N, C, W = x_shape
    _obs.event("conv.psum.model", axes="model", chunk=chunk, chunks=chunks,
               mp=mp_size(group), bytes=buf.numel() * buf.element_size(),
               N=N, C=C, K=K, S=S, dilation=dilation,
               Q=W - (S - 1) * dilation, dtype=_dtype_name(dtype),
               depthwise=False)


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
           bwd_data_cfg=None, bwd_weight_cfg=None, grad_reduce=None,
           grad_reduce_chunks: int | None = None, model_reduce=None,
           model_reduce_chunks: int | None = None) -> torch.Tensor:
    """1D dilated convolution with fused epilogue, paper semantics.

    x: (N, C, W), w: (S, K, C) -> (N, K, Q); Q == W for SAME/CAUSAL and
    Q = W - (S-1)*dilation for VALID.  ``y = act(conv + bias + residual)``
    on the fp32 accumulator with bias (K,) and residual (N, K, Q), stored
    in ``out_dtype`` (default x.dtype).

    ``tile`` pins the forward kernel's register tile; ``bwd_data_cfg`` /
    ``bwd_weight_cfg`` (a :class:`PassConfig` or its tuple) pin a backward
    pass, winning over ``"auto"``'s plan.  ``grad_reduce`` /
    ``grad_reduce_chunks``: the data-parallel sum of the weight and bias
    gradients; ``model_reduce`` / ``model_reduce_chunks``: w and bias are
    this rank's K rows, and dx is summed over the model group (module
    docstring).

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
        w, bias = _reduce_params(grad_reduce, w, bias)
        x = ModelReduceGrad.reduce(model_reduce, x, S, K, dilation)
        with _conv_span("fwd", "ref", x, w, dilation, False):
            return _ref.conv1d_fused_ref(x, w, dilation=dilation, bias=bias,
                                         activation=activation,
                                         residual=residual,
                                         out_dtype=out_dtype)
    plan = None  # the kernels with their own tiles: the default path
    if backend != "cuda" or tile is not None or backward_pinned:
        plan = _plan(backend, x, C=C, K=K, S=S, dilation=dilation,
                     padding=padding, depthwise=False, bias=bias,
                     activation=activation, residual=residual, tile=tile,
                     bwd_data_cfg=bwd_data_cfg, bwd_weight_cfg=bwd_weight_cfg)
    return fused_conv1d(x.contiguous(), w.contiguous(), bias=bias,
                        residual=residual, activation=activation,
                        dilation=dilation, out_dtype=out_dtype, plan=plan,
                        grad_reduce=grad_reduce,
                        grad_reduce_chunks=grad_reduce_chunks,
                        model_reduce=model_reduce,
                        model_reduce_chunks=model_reduce_chunks)


def fused_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 activation: str | None = None, dilation: int = 1,
                 out_dtype: torch.dtype | None = None,
                 tile: int | None = None,
                 plan: tuple[PassConfig, PassConfig, PassConfig] | None = None,
                 grad_reduce=None, grad_reduce_chunks: int | None = None,
                 model_reduce=None, model_reduce_chunks: int | None = None
                 ) -> torch.Tensor:
    """The kernel path on an already padded x (N, C, Q + (S-1)*d): through
    :class:`Conv1dFunction` when autograd records the call, else one
    launch of the forward kernel (a served call adds only the grad-mode
    check to the wrapper's host work).  ``plan`` (forward, bwd-data,
    bwd-weight :class:`PassConfig`) runs each pass on its own backend;
    ``tile`` alone pins the forward kernel's tile; with neither, the
    default, the kernels run with their own tiles.  The wrappers take the
    device from the tensors, so on CPU tensors every ``"cuda"`` pass is
    its plain version.  ``grad_reduce`` / ``grad_reduce_chunks`` and
    ``model_reduce`` / ``model_reduce_chunks`` as ``conv1d``'s."""
    if plan is None and tile is not None:
        plan = (PassConfig("cuda", tile), PassConfig(), PassConfig())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, residual)):
        return Conv1dFunction.apply(x, w, bias, residual, dilation,
                                    _ep.canon(activation), out_dtype, plan,
                                    grad_reduce, int(grad_reduce_chunks or 1),
                                    model_reduce,
                                    int(model_reduce_chunks or 1))
    with _conv_span("fwd", "cuda" if plan is None else plan[0].backend, x,
                    w, dilation, False,
                    None if plan is None else plan[0].tile):
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


def _chunk_ranges(n: int, chunks: int) -> list[tuple[int, int]]:
    """``n`` units split into ``chunks`` contiguous, near-even ``[lo, hi)``
    ranges, at least one unit each (the JAX package's ``_chunk_ranges``)."""
    chunks = max(1, min(int(chunks), n))
    base, rem = divmod(n, chunks)
    out, lo = [], 0
    for i in range(chunks):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _reducer(grad_reduce) -> GradReducer | None:
    if grad_reduce is None or isinstance(grad_reduce, GradReducer):
        return grad_reduce
    return GradReducer(grad_reduce)


def _param_grads(grad_reduce, run, x, du, *, span: int, chunks: int,
                 w: torch.Tensor, need_w: bool, bias_dtype, obs_span):
    """(dw, dbias) in w's and the bias's dtypes (None where not wanted;
    ``bias_dtype`` None: no dbias) from the bwd-weight pass ``run(x, du)``
    (fp32 dw, or (dw, dbias)).  Under ``grad_reduce`` they are summed over
    the data group: one all-reduce of one fp32 buffer ``[dw | dbias]`` per
    width range (``_chunk_ranges(Q, chunks)``, each range's x and du
    copied), the reduced partials summed in range order.  With a
    :class:`GradReducer` the reduces stay in flight and the returned
    tensors are filled when it waits (fp32 weights and one range: dw and
    dbias are views of the buffer itself); with a bare group they are
    waited on here.  ``obs_span`` (``_conv_span``) holds everything up to
    the last reduce's issue, not its wait."""
    with_dbias = bias_dtype is not None
    if grad_reduce is None:
        with obs_span:
            out = run(x, du)
            dw, db = out if with_dbias else (out, None)
            return (dw.to(w.dtype) if need_w else None,
                    db.to(bias_dtype) if with_dbias else None)
    reducer = _reducer(grad_reduce)
    reducer.claim(w.data_ptr())
    Q = du.shape[-1]
    ranges = _chunk_ranges(Q, chunks)
    n = w.numel()
    parts = []
    with obs_span:
        for lo, hi in ranges:
            out = (run(x, du) if (lo, hi) == (0, Q) else
                   run(x[:, :, lo:hi + span].contiguous(),
                       du[:, :, lo:hi].contiguous()))
            dw, db = out if with_dbias else (out, None)
            parts.append(dw.reshape(-1) if db is None
                         else torch.cat([dw.reshape(-1), db]))
        if len(parts) == 1 and w.dtype == torch.float32 and (
                not with_dbias or bias_dtype == torch.float32):
            buf = parts[0]
            reducer.all_reduce_(buf)
            dw, db = buf[:n].view(w.shape), (buf[n:] if with_dbias else None)
        else:
            dw = torch.empty_like(w)
            db = (torch.empty(parts[0].numel() - n, dtype=bias_dtype,
                              device=w.device) if with_dbias else None)

            def finish():
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                dw.copy_(total[:n].view(w.shape))
                if db is not None:
                    db.copy_(total[n:])

            for i, p in enumerate(parts):
                reducer.all_reduce_(p, finish if i == len(parts) - 1
                                    else None)
    if reducer is not grad_reduce:  # a bare group: no reducer waits later
        reducer.wait()
    return (dw if need_w else None), db


class ReduceGrad(torch.autograd.Function):
    """The identity whose backward sums the cotangent over the data group
    (JAX's ``_psum_cotangent``), in the cotangent's dtype, into a copy:
    how ``"ref"`` (autograd over the plain version) and an op outside a
    kernel (``blocks.forward_unfused``'s bias add) reduce a parameter's
    gradient.  ``reduce(grad_reduce, p)`` applies it."""

    @staticmethod
    def forward(ctx, p, grad_reduce):
        ctx.grad_reduce, ctx.key = grad_reduce, p.data_ptr()
        # kept alive until the backward, so that no other tensor (a
        # K-sharded layer's next parameter block) reuses the key's address
        ctx.save_for_backward(p)
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        reducer = _reducer(ctx.grad_reduce)
        reducer.claim(ctx.key)
        buf = g.clone(memory_format=torch.contiguous_format)
        reducer.all_reduce_(buf)
        if reducer is not ctx.grad_reduce:
            reducer.wait()
        return buf, None

    @staticmethod
    def reduce(grad_reduce, p: torch.Tensor) -> torch.Tensor:
        if grad_reduce is None or not (torch.is_grad_enabled()
                                       and p.requires_grad):
            return p
        return ReduceGrad.apply(p, grad_reduce)


def _reduce_params(grad_reduce, w, bias):
    return (ReduceGrad.reduce(grad_reduce, w),
            None if bias is None else ReduceGrad.reduce(grad_reduce, bias))


class ModelReduceGrad(torch.autograd.Function):
    """The identity whose backward sums the cotangent over the model group
    (JAX's ``_model_psum_cotangent``), waited where it is issued: how
    ``"ref"`` (autograd over the plain version) finishes a K-sharded
    layer's dx.  ``reduce(model_reduce, x, S, K, dilation)`` applies it
    to the padded input of a layer of S taps and K local filters (the
    cell of its ``conv.psum.model`` event)."""

    @staticmethod
    def forward(ctx, x, group, S, K, dilation):
        ctx.group, ctx.cell = group, (S, K, dilation)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        buf = g.clone(memory_format=torch.contiguous_format)
        _model_psum_event(buf, ctx.group, 0, 1, buf.shape, buf.dtype,
                          *ctx.cell)
        reducer = ModelReducer(ctx.group)
        reducer.all_reduce_(buf)
        reducer.wait()
        return buf, None, None, None, None

    @staticmethod
    def reduce(model_reduce, x: torch.Tensor, S: int, K: int,
               dilation: int) -> torch.Tensor:
        if model_reduce is None or not (torch.is_grad_enabled()
                                        and x.requires_grad):
            return x
        return ModelReduceGrad.apply(x, model_reduce, S, K, dilation)


def _data_grad(plan, du, w, *, x_shape, dilation: int, out_dtype,
               model_reduce, chunks: int) -> torch.Tensor:
    """dx (Alg. 3) in ``out_dtype`` from du and w of one dtype: the forward
    conv on du padded by the span on both sides against the flipped,
    transposed taps, on the kernel (``plan`` None) or the plan's bwd-data
    backend.  Under ``model_reduce`` the partial dx (this rank's K rows)
    is computed in fp32 and summed over the model group, in ``chunks``
    column ranges (module docstring), before the one cast; each sum logs
    a ``conv.psum.model`` event."""
    S, K = w.shape[0], w.shape[1]
    span = (S - 1) * dilation
    reducer = ModelReducer(model_reduce)
    dt = out_dtype if model_reduce is None else torch.float32
    ranges = _chunk_ranges(x_shape[-1], chunks)
    if model_reduce is None or len(ranges) == 1:
        if plan is None:
            dx = _k.conv1d_fwd(F.pad(du, (span, span)),
                               w.flip(0).transpose(1, 2).contiguous(),
                               dilation=dilation, out_dtype=dt)
        else:
            dx = _bwd_data_pass(plan[1], du, w, x_shape=x_shape,
                                dilation=dilation, out_dtype=dt)
        if model_reduce is not None:
            _model_psum_event(dx, model_reduce, 0, 1, x_shape, out_dtype, S,
                              K, dilation)
        reducer.all_reduce_(dx)
        reducer.wait()
        return dx.to(out_dtype)
    du_pad = F.pad(du, (span, span))
    w_t = w.flip(0).transpose(1, 2).contiguous()
    cfg = PassConfig() if plan is None else plan[1]
    parts = []
    for i, (lo, hi) in enumerate(ranges):
        part = _fwd_pass(cfg, du_pad[:, :, lo:hi + span].contiguous(), w_t,
                         dilation=dilation, out_dtype=dt)
        _model_psum_event(part, model_reduce, i, len(ranges), x_shape,
                          out_dtype, S, K, dilation)
        reducer.all_reduce_(part)  # in flight while the next range runs
        parts.append(part)
    reducer.wait()
    return torch.cat(parts, dim=-1).to(out_dtype)


class Conv1dFunction(torch.autograd.Function):
    """``act(conv(x, w) + bias + residual)`` on a padded x with its
    gradient; with ``grad_reduce`` the weight and bias gradients are
    summed over the data group right after the bwd-weight pass, with
    ``model_reduce`` dx over the model group right after bwd-data.

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
        input is data); under ``model_reduce`` summed over the model
        group in ``model_reduce_chunks`` column ranges (``_data_grad``);
      * (dw, dbias) through ``conv1d_bwd_weight``, cast to w's and the
        bias's dtypes;
      * dresidual = du in the residual's dtype.

    Each kernel call takes one dtype.  Where the operands differ (the
    bf16 model's heads give an fp32 cotangent against bf16 weights and
    inputs), the bf16 operand is widened to fp32, which is exact and is
    what the reference's fp32 accumulation computes.

    ``grad_reduce`` (a group or a ``GradReducer``) sums (dw, dbias) over
    the data group on their fp32 accumulator, before the casts, in
    ``grad_reduce_chunks`` width ranges (``_param_grads``); dx
    and dresidual stay the rank's own.
    """

    @staticmethod
    def forward(ctx, x, w, bias, residual, dilation, activation, out_dtype,
                plan=None, grad_reduce=None, grad_reduce_chunks=1,
                model_reduce=None, model_reduce_chunks=1):
        ctx.plan = plan
        ctx.grad_reduce, ctx.chunks = grad_reduce, grad_reduce_chunks
        ctx.model_reduce, ctx.model_chunks = model_reduce, model_reduce_chunks
        kw = dict(bias=bias, residual=residual, activation=activation,
                  dilation=dilation, out_dtype=out_dtype)
        preact = _ep.needs_preact(activation)
        with _conv_span("fwd", "cuda" if plan is None else plan[0].backend,
                        x, w, dilation, False,
                        None if plan is None else plan[0].tile):
            out = (_k.conv1d_fwd(x, w, save_preact=preact, **kw)
                   if plan is None
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
            with _conv_span("bwd_data",
                            "cuda" if plan is None else plan[1].backend, x,
                            w, d, False, None if plan is None
                            else plan[1].tile):
                dx = _data_grad(plan, du.to(dt), w.to(dt), x_shape=x.shape,
                                dilation=d, out_dtype=x.dtype,
                                model_reduce=ctx.model_reduce,
                                chunks=ctx.model_chunks)
        if need_w or need_b:
            dt = _widest(x.dtype, du.dtype)

            def run(xa, ga):
                if plan is None:
                    return _k.conv1d_bwd_weight(xa, ga, S=S, dilation=d,
                                                with_dbias=need_b)
                return _bwd_weight_pass(plan[2], xa, ga, S=S, dilation=d,
                                        with_dbias=need_b)

            dw, dbias = _param_grads(
                ctx.grad_reduce, run, x.to(dt), du.to(dt), span=span,
                chunks=ctx.chunks, w=w, need_w=need_w,
                bias_dtype=ctx.bias_dtype if need_b else None,
                obs_span=_conv_span(
                    "bwd_weight", "cuda" if plan is None else plan[2].backend,
                    x, w, d, False, None if plan is None else plan[2].body))
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return (dx, dw, dbias, dres) + (None,) * 8


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     residual: torch.Tensor | None = None, dilation: int = 1,
                     padding: Padding = "CAUSAL", backend: str | None = None,
                     out_dtype: torch.dtype | None = None,
                     tile: int | None = None, bwd_data_cfg=None,
                     bwd_weight_cfg=None, grad_reduce=None,
                     grad_reduce_chunks: int | None = None,
                     model_reduce=None) -> torch.Tensor:
    """Depthwise 1D conv with fused epilogue.  x: (N, C, W), w: (S, C) ->
    (N, C, Q); bias (C,), residual (N, C, Q), the epilogue of ``conv1d``.
    Every backend follows the JAX package's dtype rule: fp32 accumulation
    and epilogue math, output in ``out_dtype`` or x's dtype, whatever the
    weights' dtype.  The backends and the pins are ``conv1d``'s; the
    depthwise kernels have no tile (``tile`` must be None).
    ``grad_reduce`` / ``grad_reduce_chunks`` as ``conv1d``'s;
    ``model_reduce`` is refused (module docstring).

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
    if model_reduce is not None:
        raise ValueError(
            "depthwise_conv1d has no model-axis contraction to reduce: "
            "under channel-group sharding every output channel depends "
            "only on its own input channel, so dx, dw and dbias all stay "
            "on the rank; shard x and w on C over the model group and "
            "drop model_reduce (kernels.sharded."
            "model_sharded_depthwise_conv1d)")
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
        w, bias = _reduce_params(grad_reduce, w, bias)
        with _conv_span("fwd", "ref", x, w, dilation, True):
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
                                  plan=plan, grad_reduce=grad_reduce,
                                  grad_reduce_chunks=grad_reduce_chunks)


def fused_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                           bias: torch.Tensor | None = None,
                           residual: torch.Tensor | None = None,
                           activation: str | None = None, dilation: int = 1,
                           out_dtype: torch.dtype | None = None,
                           plan: tuple[PassConfig, PassConfig,
                                       PassConfig] | None = None,
                           grad_reduce=None,
                           grad_reduce_chunks: int | None = None
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
            plan, grad_reduce, int(grad_reduce_chunks or 1))
    kw = dict(bias=bias, residual=residual, activation=activation,
              dilation=dilation, out_dtype=out_dtype or x.dtype)
    with _conv_span("fwd", "cuda" if plan is None else plan[0].backend, x,
                    w, dilation, True):
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
    its gradient, the counterpart of the ``_dw_conv1d_pallas`` custom VJP;
    ``plan``, ``grad_reduce`` and ``grad_reduce_chunks`` as
    :class:`Conv1dFunction`'s.

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
                plan=None, grad_reduce=None, grad_reduce_chunks=1):
        ctx.plan = plan
        ctx.grad_reduce, ctx.chunks = grad_reduce, grad_reduce_chunks
        kw = dict(bias=bias, residual=residual, activation=activation,
                  dilation=dilation, out_dtype=out_dtype or x.dtype,
                  save_preact=_ep.needs_preact(activation))
        with _conv_span("fwd", "cuda" if plan is None else plan[0].backend,
                        x, w, dilation, True):
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
            with _conv_span("bwd_data",
                            "cuda" if plan is None else plan[1].backend, x,
                            w, d, True):
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
            def run(xa, ga):
                if plan is None or plan[2].backend == "cuda":
                    # the kernel reads x and du each in its own dtype
                    return _k.depthwise_conv1d_bwd_weight(
                        xa, ga, S=S, dilation=d, with_dbias=need_b)
                # the library and the plain version take one
                dt = _widest(xa.dtype, ga.dtype)
                return _bwd_weight_pass(plan[2], xa.to(dt), ga.to(dt), S=S,
                                        dilation=d, with_dbias=need_b,
                                        depthwise=True)

            dw, dbias = _param_grads(
                ctx.grad_reduce, run, x, du, span=span, chunks=ctx.chunks,
                w=w, need_w=need_w,
                bias_dtype=ctx.bias_dtype if need_b else None,
                obs_span=_conv_span(
                    "bwd_weight", "cuda" if plan is None else plan[2].backend,
                    x, w, d, True))
        if need_r:
            dres = du.to(ctx.residual_dtype)
        return dx, dw, dbias, dres, None, None, None, None, None, None


def conv_stream_state(batch: int, c_in: int, S: int, dilation: int,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Fresh per-layer streaming state ``(batch, c_in, (S-1)*dilation)``: the
    input columns the causal conv reaches back over, zeros while there is
    no history (zeros are the CAUSAL left padding)."""
    return torch.zeros((batch, c_in, (S - 1) * dilation), dtype=dtype,
                       device=device)


def _stream_call(conv_fn, x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor, span: int, kwargs: dict
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming engine of both convs: ONE VALID pass of ``conv_fn``
    over ``[state | chunk]`` (only the chunk's columns are computed), and
    the last ``span`` input columns of that window as a dense copy, so the
    new state does not pin the whole window."""
    N, Cx, W = x.shape
    if tuple(state.shape) != (N, Cx, span):
        raise ValueError(f"streaming state shape {tuple(state.shape)} does "
                         f"not match (N={N}, C_in={Cx}, span={span})")
    if state.dtype != x.dtype:
        raise ValueError(f"streaming state dtype {state.dtype} != chunk "
                         f"dtype {x.dtype}; init the state with the stream's "
                         "input dtype")
    xc = torch.cat([state, x], dim=-1) if span else x
    y = conv_fn(xc, w, padding="VALID", **kwargs)
    return y, xc[:, :, xc.shape[-1] - span:].contiguous()


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
    S = w.shape[0]
    return _stream_call(
        conv1d, x, w, state, (S - 1) * dilation,
        dict(bias=bias, activation=activation, residual=residual,
             dilation=dilation, backend=backend, out_dtype=out_dtype))


def depthwise_conv1d_streaming(x: torch.Tensor, w: torch.Tensor, *,
                               state: torch.Tensor,
                               bias: torch.Tensor | None = None,
                               activation: str | None = None,
                               residual: torch.Tensor | None = None,
                               dilation: int = 1, backend: str | None = None,
                               out_dtype: torch.dtype | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of the causal depthwise conv1d (Mamba2's conv,
    the dilation kept general): x (N, C, W_chunk), w (S, C), ``state``
    (N, C, (S-1)*d) in x's dtype (:func:`conv_stream_state` with c_in = C).
    The contract of :func:`conv1d_streaming`: on a CUDA tensor one
    ``depthwise_conv1d_fwd`` launch over ``[state | chunk]``, whose
    summation order does not depend on the width, so a chunked stream is
    bitwise the one-shot causal call through the kernel.

    Example (CPU, the plain version)::

        >>> import torch
        >>> from repro_torch.kernels import ops
        >>> w = torch.ones(4, 8)
        >>> st = ops.conv_stream_state(2, 8, S=4, dilation=1)
        >>> y, st = ops.depthwise_conv1d_streaming(torch.ones(2, 8, 1), w,
        ...                                        state=st)
        >>> y.shape, st.shape
        (torch.Size([2, 8, 1]), torch.Size([2, 8, 3]))
    """
    S = w.shape[0]
    return _stream_call(
        depthwise_conv1d, x, w, state, (S - 1) * dilation,
        dict(bias=bias, activation=activation, residual=residual,
             dilation=dilation, backend=backend, out_dtype=out_dtype))
