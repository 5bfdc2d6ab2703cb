"""Streaming inference for the dilated-conv family (counterpart of
``repro/core/streaming.py``).

Each of the 25 causal layers carries a ring buffer of the last
``(S-1)*dilation`` input columns (:func:`init_stream_state`; zeros are the
CAUSAL left padding).  :func:`stream_step` runs every layer as ONE VALID
pass over ``state ++ chunk`` (``ops.conv1d_streaming``) and slides each
buffer, so a chunk's outputs are the one-shot
``blocks.forward(padding="CAUSAL")`` values for its columns with nothing of
the receptive field recomputed.  Through the CUDA kernel they are bitwise
equal (the kernel's summation order does not depend on the width).
:func:`prefill` is :func:`stream_step` on a fresh state.  ``fused=False``
runs each layer as ``blocks.forward_unfused`` does: the conv alone, then
the bias, the residual and the fp32 relu as separate ops.

Streaming is causal by construction: SAME/VALID padding need future
context and raise :class:`StreamingUnsupported`.
"""
from __future__ import annotations

import torch

from repro_torch.core import blocks
from repro_torch.kernels import ops as kops


class StreamingUnsupported(ValueError):
    """The requested conv configuration has no streaming form."""


def validate_streamable(padding: str = "CAUSAL") -> None:
    """Raise :class:`StreamingUnsupported` unless ``padding`` is CAUSAL."""
    if padding != "CAUSAL":
        raise StreamingUnsupported(
            f"streaming conv1d requires CAUSAL padding; {padding!r} needs "
            "future context at every output position — run the one-shot "
            "blocks.forward over the full sequence instead")


def layer_span(cfg) -> int:
    """Columns of carried state per layer: ``(S-1) * dilation``."""
    return (cfg.conv_filter - 1) * cfg.conv_dilation


def receptive_field(cfg) -> int:
    """Total look-back of the 25-layer stack."""
    return (2 * blocks.N_RES_BLOCKS + 3) * layer_span(cfg)


def init_stream_state(cfg, batch: int, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Fresh per-layer ring buffers in a tree mirroring the parameters.
    ``dtype`` is the stream's input dtype."""
    S, d, C = cfg.conv_filter, cfg.conv_dilation, cfg.conv_channels

    def buf(c_in):
        return kops.conv_stream_state(batch, c_in, S, d, dtype, device)

    return {
        "stem": buf(1),
        "res": [{"conv1": buf(C), "conv2": buf(C)}
                for _ in range(blocks.N_RES_BLOCKS)],
        "head_signal": buf(C),
        "head_peak": buf(C),
    }


def stream_step(model, cfg, state: dict, chunk: torch.Tensor, *,
                padding: str = "CAUSAL", fused: bool | None = None):
    """One streaming step of the conv stack.

    chunk: (B, W_chunk) -> ``((signal, peak_logits), new_state)``, both
    outputs (B, W_chunk) fp32.  ``state`` is not modified; ``new_state``
    holds fresh buffers.  Each layer runs the kernel on a CUDA tensor and
    the plain version on a CPU one (``ops.default_backend``).  ``fused``
    (default ``blocks.FUSED_DEFAULT``) picks the fused epilogue or the
    unfused composition; prefill and steps of one stream should agree.
    """
    validate_streamable(padding)
    if fused is None:
        fused = blocks.FUSED_DEFAULT
    d = cfg.conv_dilation
    new = {"res": []}

    def layer(conv, buf, h, **kw):
        if fused:
            return kops.conv1d_streaming(h, conv.w, state=buf, bias=conv.b,
                                         dilation=d, **kw)
        # the unfused composition, op for op blocks.forward_unfused's
        y, nbuf = kops.conv1d_streaming(h, conv.w, state=buf, dilation=d)
        y = y + conv.b[None, :, None].to(y.dtype)
        act, res = kw.get("activation"), kw.get("residual")
        out_dtype = kw.get("out_dtype")
        if res is not None:
            y = (res + y).float()
        elif act is not None or out_dtype is not None:
            y = y.float()
        if act == "relu":
            y = torch.relu(y)
        return y.to(out_dtype if out_dtype is not None else h.dtype), nbuf

    h = chunk[:, None, :]  # (B, 1, W)
    h, new["stem"] = layer(model.stem, state["stem"], h, activation="relu")
    for blk, buf in zip(model.res, state["res"]):
        r, s1 = layer(blk.conv1, buf["conv1"], h, activation="relu")
        h, s2 = layer(blk.conv2, buf["conv2"], r, activation="relu",
                      residual=h)
        new["res"].append({"conv1": s1, "conv2": s2})
    signal, new["head_signal"] = layer(
        model.head_signal, state["head_signal"], h, activation="relu",
        out_dtype=torch.float32)
    peak, new["head_peak"] = layer(model.head_peak, state["head_peak"], h,
                                   out_dtype=torch.float32)
    return (signal[:, 0, :], peak[:, 0, :]), new


def prefill(model, cfg, history: torch.Tensor, *, padding: str = "CAUSAL",
            fused: bool | None = None):
    """Initialise streaming state from a history in ONE pass: history
    (B, W_hist) -> ``((signal, peak_logits), state)``; this is
    :func:`stream_step` on a fresh state."""
    validate_streamable(padding)
    state = init_stream_state(cfg, history.shape[0], history.dtype,
                              history.device)
    return stream_step(model, cfg, state, history, fused=fused)
