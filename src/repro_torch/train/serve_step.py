"""Serve-step factories of the conv family (counterpart of the conv part of
``repro/train/serve_step.py``).

Each step runs under ``torch.inference_mode()``: serving needs no
gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core import streaming


def make_conv_stream_state(cfg, batch: int,
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str = "cpu") -> dict:
    """Per-layer ring buffers of the last ``(S-1)*dilation`` input columns
    (``core.streaming.init_stream_state``)."""
    return streaming.init_stream_state(cfg, batch, dtype, device)


def make_conv_stream_step(cfg):
    """``stream_step(model, state, chunk) -> ((signal, peak), new_state)``:
    the causal forward's outputs for the chunk's columns only, against the
    carried per-layer state."""

    @torch.inference_mode()
    def stream_step(model, state, chunk):
        return streaming.stream_step(model, cfg, state, chunk)

    return stream_step


def make_conv_prefill_step(cfg):
    """``prefill_step(model, history) -> ((signal, peak), state)``: one
    full-sequence pass that leaves every layer's ring buffer behind."""

    @torch.inference_mode()
    def prefill_step(model, history):
        return streaming.prefill(model, cfg, history)

    return prefill_step
