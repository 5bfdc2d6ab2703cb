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
"""
from __future__ import annotations

import os

import torch
from torch import nn

from repro_torch.core.conv1d import DilatedConv1D
from repro_torch.kernels import ops as kops

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
            grad_reduce_chunks: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, W) noisy coverage track -> (signal (B, W), peak_logits (B, W)),
    both fp32.  ``padding="CAUSAL"`` is the streaming-servable variant:
    the one-shot reference the chunked ``core.streaming`` path matches.

    ``grad_reduce``: the data group (or its per-step ``GradReducer``) when
    ``x`` is one rank's share of the batch: every layer's weight and bias
    gradients are then summed over it right after that layer's
    bwd-weight pass, in ``grad_reduce_chunks`` width ranges.
    ``fused=False`` (default ``FUSED_DEFAULT``) runs
    :func:`forward_unfused`."""
    if fused is None:
        fused = FUSED_DEFAULT
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
            grad_reduce_chunks: int | None = None):
    """AtacWorks loss: MSE(denoised signal) + BCE(peak calls), weighted
    1:1, the BCE in its numerically stable form on the logits.

    batch: ``noisy``/``clean`` (B, W) fp32 and ``peaks`` (B, W) int8
    (``data.synthetic.atacseq_batch``); ``noisy`` is cast to the model's
    dtype, as the server casts its chunks.  Returns ``(loss, {"mse",
    "bce"})``, fp32 scalars (0-d tensors).  ``fused``, ``grad_reduce``
    and ``grad_reduce_chunks`` as :func:`forward`'s.
    """
    dtype = next(model.parameters()).dtype
    signal, peak_logits = forward(model, cfg, batch["noisy"].to(dtype),
                                  backend=backend, fused=fused,
                                  grad_reduce=grad_reduce,
                                  grad_reduce_chunks=grad_reduce_chunks)
    mse = torch.mean((signal - batch["clean"].float()) ** 2)
    labels = batch["peaks"].float()
    bce = torch.mean(torch.clamp(peak_logits, min=0) - peak_logits * labels
                     + torch.log1p(torch.exp(-peak_logits.abs())))
    return mse + bce, {"mse": mse, "bce": bce}
