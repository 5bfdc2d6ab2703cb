"""Serve-step factories (counterpart of ``repro/train/serve_step.py``):
the language models' batched greedy decode step, their cache and their
fused prefill step, and the conv family's streaming steps.

Each step runs under ``torch.inference_mode()``: serving needs no
gradient (and with ``cfg.remat`` each layer runs once).
``with_request_spans`` times a step as a client sees it.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import streaming
from repro_torch.models import get_model


def with_request_spans(step_fn, name: str, device=None, **attrs):
    """``step_fn`` with every host-level call timed as a request-latency
    span ``name`` (JAX's ``with_request_spans``): the call and, on a CUDA
    ``device``, a ``torch.cuda.synchronize`` of it, what a client waits
    for (JAX's ``block_until_ready``); the pending device spans of the
    call's passes are written after it.  With telemetry off the wrapper
    adds one ``enabled()`` check."""

    def wrapped(*a, **kw):
        if not obs.enabled():
            return step_fn(*a, **kw)
        with obs.span(name, **attrs):
            out = step_fn(*a, **kw)
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        obs.flush()
        return out

    return wrapped


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax of the last position over the padded vocabulary (its
    padded columns are ``NEG_INF``), as (B, 1) int32."""
    return logits[:, -1, :].argmax(-1).to(torch.int32)[:, None]


def make_serve_step(cfg):
    """``serve_step(model, cache, tokens, pos) -> (next_tokens, cache,
    logits)``: one batched decode step, tokens (B, 1) int at position
    ``pos`` (the cache's valid length), greedy next tokens (B, 1) int32,
    fp32 logits (B, 1, padded_vocab); the cache is updated in place."""
    model_mod = get_model(cfg)

    @torch.inference_mode()
    def serve_step(model, cache, tokens, pos: int):
        logits, cache = model_mod.decode_step(model, cache, tokens, pos)
        return _greedy(logits), cache, logits

    return serve_step


def make_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu",
               enc_len: int | None = None) -> dict:
    """The family's decode cache (``init_cache``), zeros; ``enc_len`` sets
    an encoder-decoder's cross-attention length (default
    ``cfg.encoder_width``)."""
    kw = {"enc_len": enc_len} if cfg.family == "encdec" else {}
    return get_model(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                     device=device, **kw)


def make_prefill_step(cfg):
    """``prefill_step(model, batch) -> (next_tokens, logits)``: the fused
    prefill, ONE full-sequence forward over ``batch["tokens"]`` (B, T)
    (with an encoder-decoder's ``batch["frames"]``) with the logits of
    the last position only (B, 1, padded_vocab); the (B, T, V) logits are
    never made.  On the card it runs the family's kernels: Mamba2's and
    Zamba2's convs through ``depthwise_conv1d_fwd``, a dense or MoE
    model's attention, Whisper's encoder and decoder self-attention and
    Zamba2's shared block through ``flash_fwd`` when ``cfg.attn_impl ==
    "flash"``."""
    model_mod = get_model(cfg)

    @torch.inference_mode()
    def prefill_step(model, batch):
        kw = {"frames": batch["frames"]} if cfg.family == "encdec" else {}
        logits = model_mod.forward(model, batch["tokens"], last_only=True,
                                   **kw)
        if cfg.family == "moe":
            logits, _ = logits  # and the load-balance loss
        return _greedy(logits), logits

    return prefill_step


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
