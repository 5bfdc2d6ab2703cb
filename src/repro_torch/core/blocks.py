"""AtacWorks-style 1D dilated-conv ResNet (paper §4.2) on the DilatedConv1D
layer — counterpart of ``repro/core/blocks.py``.

Always 25 conv layers: a stem (1->C), 11 residual
blocks of two convs (C->C) and two 1-channel heads (denoised signal, peak
logits).  Each residual block is two fused kernel calls::

    r = relu(conv1(h) + b1)
    h = relu(conv2(r) + b2 + h)

The state-dict keys mirror the JAX parameter tree: ``stem.w``,
``res.<i>.conv1.b``, ``head_signal.w``, ...  ``loss_fn`` is the training
loss: MSE of the denoised signal plus BCE of the peak calls.

``forward_unfused`` keeps the pre-fusion composition (conv, bias add,
fp32 relu and residual add as separate ops), the baseline of the fused
forward; ``REPRO_FUSED_EPILOGUE=0``, read when the module is imported,
routes ``forward`` to it.  ``grad_reduce`` / ``grad_reduce_chunks``
(``kernels/ops.py``) reach every layer: the data-parallel path.
``model_group``, a model group of mp > 1 ranks, K-shards every layer
whose filter count divides (``_forward_model_sharded``): the
tensor-parallel path.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from repro_torch.core.conv1d import DilatedConv1D
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sharded as sh
from repro_torch.kernels.reduce import mp_rank, mp_size

N_RES_BLOCKS = 11  # 1 stem + 11*2 res + 2 heads = 25 conv layers
FUSED_DEFAULT = os.environ.get("REPRO_FUSED_EPILOGUE", "1") != "0"


class ResBlock(nn.Module):
    def __init__(self, C: int, S: int, **kw):
        super().__init__()
        self.conv1 = DilatedConv1D(C, C, S, **kw)
        self.conv2 = DilatedConv1D(C, C, S, **kw)


class AtacWorks(nn.Module):
    """The 25-layer stack; ``forward(x)`` is :func:`forward` on itself."""

    def __init__(self, cfg, *, device: torch.device | str = "cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        C, S = cfg.conv_channels, cfg.conv_filter
        kw = dict(dtype=getattr(torch, cfg.dtype), device=device,
                  generator=generator)
        self.stem = DilatedConv1D(1, C, S, **kw)
        self.res = nn.ModuleList(ResBlock(C, S, **kw)
                                 for _ in range(N_RES_BLOCKS))
        self.head_signal = DilatedConv1D(C, 1, S, **kw)
        self.head_peak = DilatedConv1D(C, 1, S, **kw)

    def forward(self, x: torch.Tensor, *, backend: str | None = None,
                padding: str = "SAME") -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self, self.cfg, x, backend=backend, padding=padding)


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> AtacWorks:
    """The stack with weights drawn from a generator seeded with ``seed``
    (the same weights on every device; biases are zeros)."""
    return AtacWorks(cfg, device=device,
                     generator=torch.Generator().manual_seed(seed))


def forward(model: AtacWorks, cfg, x: torch.Tensor, *,
            backend: str | None = None, padding: str = "SAME",
            fused: bool | None = None, grad_reduce=None,
            grad_reduce_chunks: int | None = None, model_group=None,
            model_reduce_chunks: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, W) noisy coverage track -> (signal (B, W), peak_logits (B, W)),
    both fp32.  ``padding="CAUSAL"`` is the streaming-servable variant:
    the one-shot reference the chunked ``core.streaming`` path matches.

    ``grad_reduce``: the data group (or its per-step ``GradReducer``) when
    ``x`` is one rank's share of the batch: every layer's weight and bias
    gradients are then summed over it right after that layer's
    bwd-weight pass, in ``grad_reduce_chunks`` width ranges.
    ``fused=False`` (default ``FUSED_DEFAULT``) runs
    :func:`forward_unfused`.

    ``model_group``, a model group of mp > 1 ranks (``mp_size``; JAX
    passes the size beside the axis name, which it cannot read while
    tracing), K-shards every layer whose filter count divides over the
    model group (tensor parallelism, :func:`_forward_model_sharded`);
    ``model_reduce_chunks`` chunks each layer's dx sum; ``grad_reduce``
    and its chunks still sum every layer's gradients over the data group
    first.  Requires the fused path and C % mp == 0."""
    if fused is None:
        fused = FUSED_DEFAULT
    mp = mp_size(model_group)
    if mp > 1:
        if not fused:
            raise ValueError(
                "model-parallel forward requires the fused path "
                "(REPRO_FUSED_EPILOGUE=0 / fused=False is the pre-fusion "
                "baseline only)")
        return _forward_model_sharded(
            model, cfg, x, backend=backend, padding=padding,
            grad_reduce=grad_reduce, grad_reduce_chunks=grad_reduce_chunks,
            model_group=model_group, mp=mp,
            model_reduce_chunks=model_reduce_chunks)
    if not fused:
        return forward_unfused(model, cfg, x, backend=backend,
                               padding=padding, grad_reduce=grad_reduce,
                               grad_reduce_chunks=grad_reduce_chunks)
    kw = dict(dilation=cfg.conv_dilation, backend=backend, padding=padding,
              grad_reduce=grad_reduce, grad_reduce_chunks=grad_reduce_chunks)
    h = x[:, None, :]  # (B, 1, W)
    h = model.stem(h, activation="relu", **kw)
    for blk in model.res:
        r = blk.conv1(h, activation="relu", **kw)
        h = blk.conv2(r, activation="relu", residual=h, **kw)
    signal = model.head_signal(h, activation="relu", out_dtype=torch.float32,
                               **kw)[:, 0, :]
    peak = model.head_peak(h, out_dtype=torch.float32, **kw)[:, 0, :]
    return signal, peak


def _mp_apply(conv: DilatedConv1D, h: torch.Tensor, *, cfg, backend,
              padding, mp, group, gra, grc, mrc, activation=None,
              residual=None, out_dtype=None, input_grad=True):
    """One conv layer K-sharded over the model group ``group`` (JAX's
    ``_mp_apply``).

    A layer whose filter count divides (K % mp == 0) takes this rank's
    block of its replicated w and b (``shard_param``) and of the residual
    (``shard_block``, a plain slice whose cotangent stays the rank's
    own), runs the conv at the local K and gathers the output along K
    (``model_concat``).  Its backward sums, in JAX's order, the block's
    (dw, dbias) over the data group right after bwd-weight (``gra``, in
    ``grc`` width ranges), then the zero-padded blocks over the model
    group (``shard_param``), and dx over the model group right after
    bwd-data (in ``mrc`` column ranges).  ``input_grad=False`` skips the
    dx sum where no one reads dx (the stem: x is data).

    A layer whose K does not divide (the heads' K=1 < mp) runs
    replicated: every model rank computes the same layer on the same data
    shard, so the data reduce ``gra`` alone gives every rank the same
    full gradient."""
    kw = dict(dilation=cfg.conv_dilation, backend=backend, padding=padding,
              activation=activation, out_dtype=out_dtype, grad_reduce=gra,
              grad_reduce_chunks=grc)
    K = conv.w.shape[1]
    if mp == 1 or K % mp:
        return conv(h, residual=residual, **kw)
    r = mp_rank(group)
    y = kops.conv1d(
        h, sh.shard_param(conv.w, 1, mp, r, group, gra),
        bias=sh.shard_param(conv.b, 0, mp, r, group, gra),
        residual=(None if residual is None
                  else sh.shard_block(residual, 1, mp, r)),
        model_reduce=group if input_grad else None,
        model_reduce_chunks=mrc, **kw)
    return sh.model_concat(y, 1, group)


def _forward_model_sharded(model: AtacWorks, cfg, x: torch.Tensor, *,
                           backend, padding, grad_reduce, grad_reduce_chunks,
                           model_group, mp, model_reduce_chunks):
    """The fused forward with every layer that divides K-sharded over the
    model group (see :func:`forward`; the same layer graph and math)."""
    kw = dict(cfg=cfg, backend=backend, padding=padding, mp=mp,
              group=model_group, gra=grad_reduce, grc=grad_reduce_chunks,
              mrc=model_reduce_chunks)
    h = x[:, None, :]  # (B, 1, W)
    # the stem: x is training data, nothing upstream reads dx
    h = _mp_apply(model.stem, h, activation="relu", input_grad=False, **kw)
    for blk in model.res:
        r = _mp_apply(blk.conv1, h, activation="relu", **kw)
        h = _mp_apply(blk.conv2, r, activation="relu", residual=h, **kw)
    signal = _mp_apply(model.head_signal, h, activation="relu",
                       out_dtype=torch.float32, **kw)[:, 0, :]
    peak = _mp_apply(model.head_peak, h, out_dtype=torch.float32,
                     **kw)[:, 0, :]
    return signal, peak


def forward_unfused(model: AtacWorks, cfg, x: torch.Tensor, *,
                    backend: str | None = None, padding: str = "SAME",
                    grad_reduce=None, grad_reduce_chunks: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-fusion baseline, op for op the JAX package's: each layer's
    conv with no epilogue, then the bias add, the fp32 relu round trip and
    the residual add as separate ops.  Under ``grad_reduce`` the conv
    sums its weight gradient in its backward and the bias add, outside the
    kernel, sums the bias gradient through ``ops.ReduceGrad``."""
    relu = torch.relu

    def conv_bias(conv, h):
        y = kops.conv1d(h, conv.w, dilation=cfg.conv_dilation,
                        padding=padding, backend=backend,
                        grad_reduce=grad_reduce,
                        grad_reduce_chunks=grad_reduce_chunks)
        b = kops.ReduceGrad.reduce(grad_reduce, conv.b)
        return y + b[None, :, None].to(y.dtype)

    h = x[:, None, :]  # (B, 1, W)
    h = relu(conv_bias(model.stem, h).float()).to(h.dtype)
    for blk in model.res:
        r = relu(conv_bias(blk.conv1, h).float()).to(h.dtype)
        r = conv_bias(blk.conv2, r)
        h = relu((h + r).float()).to(h.dtype)
    signal = conv_bias(model.head_signal, h)[:, 0, :]
    peak = conv_bias(model.head_peak, h)[:, 0, :]
    return relu(signal.float()), peak.float()


def loss_fn(model: AtacWorks, cfg, batch: dict, *, backend: str | None = None,
            fused: bool | None = None, grad_reduce=None,
            grad_reduce_chunks: int | None = None, **model_axis):
    """AtacWorks loss: MSE(denoised signal) + BCE(peak calls), weighted
    1:1, the BCE in its numerically stable form on the logits.

    batch: ``noisy``/``clean`` (B, W) fp32 and ``peaks`` (B, W) int8
    (``data.synthetic.atacseq_batch``); ``noisy`` is cast to the model's
    dtype, as the server casts its chunks.  Returns ``(loss, {"mse",
    "bce"})``, fp32 scalars (0-d tensors).  ``fused``, ``grad_reduce``,
    ``grad_reduce_chunks`` and the model axis's keywords (``model_group``,
    ``model_reduce_chunks``) as :func:`forward`'s.
    """
    dtype = next(model.parameters()).dtype
    signal, peak_logits = forward(model, cfg, batch["noisy"].to(dtype),
                                  backend=backend, fused=fused,
                                  grad_reduce=grad_reduce,
                                  grad_reduce_chunks=grad_reduce_chunks,
                                  **model_axis)
    mse = torch.mean((signal - batch["clean"].float()) ** 2)
    labels = batch["peaks"].float()
    bce = torch.mean(torch.clamp(peak_logits, min=0) - peak_logits * labels
                     + torch.log1p(torch.exp(-peak_logits.abs())))
    return mse + bce, {"mse": mse, "bce": bce}
