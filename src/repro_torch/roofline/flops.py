"""Operation and byte counts: the conv layer's, and parameter counts and
useful flops per step of the port's configs (counterpart of
``repro/roofline/flops.py``, for the families the port has: conv, ssm,
dense).

``conv1d_flops`` is the paper's efficiency denominator; ``model_flops``
is the useful compute of one step (6·N·D for training plus the exact
attention or SSD terms), ``model_bytes`` its memory floor.  A step is
any object with ``kind`` ("train", "prefill" or "decode"),
``global_batch`` and ``seq_len`` (``StepShape``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

# AtacWorks: 1 stem + 11 residual blocks of two convs + 2 heads
# (repro_torch/core/blocks.py; kept here so counting imports no torch)
N_RES_BLOCKS = 11


@dataclasses.dataclass(frozen=True)
class StepShape:
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


def conv1d_flops(N: int, C: int, K: int, S: int, Q: int) -> float:
    """MACs x 2 of one forward dilated conv1d (dilation moves taps, it
    does not change the count)."""
    return 2.0 * N * C * K * S * Q


def conv1d_min_bytes(N: int, C: int, K: int, S: int, Q: int,
                     dilation: int, bytes_per_elem: int) -> float:
    """Memory floor of one forward pass: read x and w once, write the
    output once."""
    W = Q + (S - 1) * dilation
    return float(bytes_per_elem * (N * C * W + S * K * C + N * K * Q))


def _attn_params(cfg) -> int:
    D, hd = cfg.d_model, cfg.head_dim
    return D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * D


def _mlp_params(cfg, d_ff: int) -> int:
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _ssm_dims(cfg) -> tuple[int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def _ssm_block_params(cfg) -> int:
    s = cfg.ssm
    d_inner, H = _ssm_dims(cfg)
    gN = s.n_groups * s.d_state
    conv_dim = d_inner + 2 * gN
    return (cfg.d_model * (2 * d_inner + 2 * gN + H)
            + s.conv_width * conv_dim + d_inner * cfg.d_model)


def _conv_per_point(cfg) -> int:
    """Weights of the AtacWorks stack per tap and input column: stem C,
    22 body convs C*C, 2 heads C."""
    C = cfg.conv_channels
    return C + 2 * N_RES_BLOCKS * C * C + 2 * C


def param_count(cfg) -> int:
    if cfg.family == "conv":
        return cfg.conv_filter * _conv_per_point(cfg)
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "dense":
        return emb + cfg.n_layers * (_attn_params(cfg)
                                     + _mlp_params(cfg, cfg.d_ff))
    if cfg.family == "ssm":
        return emb + cfg.n_layers * _ssm_block_params(cfg)
    raise ValueError(f"family {cfg.family!r} is not ported")


def _attn_seq_flops(cfg, B: int, T: int, causal: bool = True) -> int:
    """QK^T + AV flops of one full-sequence pass (dense), or the SSD's
    intra-chunk and state flops (ssm), all layers."""
    factor = 0.5 if causal else 1.0
    if cfg.family == "dense":
        return int(4 * B * T * T * cfg.n_heads * cfg.head_dim * factor
                   * cfg.n_layers)
    if cfg.family == "ssm":
        s = cfg.ssm
        _, H = _ssm_dims(cfg)
        per_layer = (4 * B * T * s.chunk * H * s.head_dim
                     + 6 * B * T * H * s.head_dim * s.d_state)
        return int(per_layer * cfg.n_layers)
    return 0


def model_flops(cfg, shape) -> float:
    """Useful flops of one step of ``shape``."""
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "conv":
        # 2 flops per weight per output point; forward + backward = 3x
        per_pt = 2 * cfg.conv_filter * _conv_per_point(cfg)
        mult = 3 if shape.kind == "train" else 1
        return float(mult * B * T * per_pt)
    n = param_count(cfg)
    if shape.kind == "train":
        return float(6 * n * B * T + 3 * _attn_seq_flops(cfg, B, T))
    if shape.kind == "prefill":
        return float(2 * n * B * T + _attn_seq_flops(cfg, B, T))
    if cfg.family == "ssm":  # decode: one token against the states
        s = cfg.ssm
        _, H = _ssm_dims(cfg)
        return float(2 * n * B
                     + 6 * B * H * s.head_dim * s.d_state * cfg.n_layers)
    # dense decode: one token, attention reads the whole cache
    return float(2 * n * B
                 + 4 * B * T * cfg.n_heads * cfg.head_dim * cfg.n_layers)


def hbm_bytes_decode(cfg, shape) -> float:
    """Least device-memory traffic of one decode step: the parameters
    (bf16) and the cache (the SSM's fp32 states read and written)."""
    B, T = shape.global_batch, shape.seq_len
    p_bytes = 2 * param_count(cfg)
    if cfg.family == "ssm":
        s = cfg.ssm
        _, H = _ssm_dims(cfg)
        return float(p_bytes
                     + 4 * B * H * s.head_dim * s.d_state * cfg.n_layers * 2)
    cache = 2 * B * T * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers
    return float(p_bytes + cache)


def model_bytes(cfg, shape) -> float:
    """Least device-memory traffic of one step.  train: bf16 parameters
    read, fp32 gradients, AdamW's moments read and written, parameters
    written, one activations pass; prefill: parameters and activations;
    decode: ``hbm_bytes_decode``."""
    if shape.kind == "decode":
        return hbm_bytes_decode(cfg, shape)
    B, T = shape.global_batch, shape.seq_len
    act = 2 * B * T * max(cfg.d_model, 1)
    if cfg.family == "conv":
        act = 4 * B * T * cfg.conv_channels
    p = param_count(cfg)
    if shape.kind == "train":
        return float(2 * p + 4 * p + 2 * 2 * 4 * p + 2 * p + 6 * act)
    return float(2 * p + 2 * act)
