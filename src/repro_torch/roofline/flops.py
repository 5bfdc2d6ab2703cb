"""Operation and byte counts: the conv layer's, and parameter counts and
useful flops per step of the port's configs (counterpart of
``repro/roofline/flops.py``, for every family: conv, ssm, dense, moe
(MLA among them), vlm (counted as dense, over its image and text
positions), encdec, hybrid).

``conv1d_flops`` is the paper's efficiency denominator; ``model_flops``
is the useful compute of one step (6·N·D for training, N the parameters
a token uses: an MoE model's active ones, plus the exact attention or SSD
terms), ``model_bytes`` its memory floor.  A step is
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


def flash_fwd_flops(B: int, Tq: int, Tk: int, H: int, hd: int,
                    causal: bool = True) -> float:
    """QK^T + AV flops of one ``flash_fwd`` call over H query heads: the
    closed form of :func:`_attn_seq_flops` for one layer, halved for a
    causal mask."""
    return 4.0 * B * Tq * Tk * H * hd * (0.5 if causal else 1.0)


def flash_bwd_flops(B: int, Tq: int, Tk: int, H: int, hd: int,
                    causal: bool = True) -> float:
    """The products of one ``flash_bwd`` call: 3.5 times the forward's
    (the dQ kernel recomputes QK^T and forms dP and dQ, the dK/dV kernel
    recomputes QK^T and forms dP, dV and dK: seven products of the
    forward's two)."""
    return 3.5 * flash_fwd_flops(B, Tq, Tk, H, hd, causal)


def _attn_params(cfg) -> int:
    """An attention block's projections; an MLA block's five (the query's
    two low-rank ones, the latent's down and up, ``wo``; no norms)."""
    if cfg.mla is not None:
        a, D, H = cfg.mla, cfg.d_model, cfg.n_heads
        qh = a.qk_nope_head_dim + a.qk_rope_head_dim
        return (D * a.q_lora_rank + a.q_lora_rank * H * qh
                + D * (a.kv_lora_rank + a.qk_rope_head_dim)
                + a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim)
                + H * a.v_head_dim * D)
    D, hd = cfg.d_model, cfg.head_dim
    return D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * D


def _mlp_params(cfg, d_ff: int) -> int:
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _moe_layer_params(cfg, active_only: bool) -> int:
    """An MoE layer's FFN: the router, the routed experts (``top_k`` of
    them with ``active_only``) and the shared ones (JAX's count: no
    ``router_bias``)."""
    m = cfg.moe
    n_routed = m.top_k if active_only else m.n_experts
    return (cfg.d_model * m.n_experts
            + (n_routed + m.n_shared) * 3 * cfg.d_model * m.d_ff_expert)


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


def _shared_block_params(cfg) -> int:
    """Zamba2's shared block: Q, K and V from the 2·D concat, ``wo`` and
    the MLP (JAX's count: no norms)."""
    D, hd = cfg.d_model, cfg.head_dim
    return (2 * D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + cfg.n_heads * hd * D + _mlp_params(cfg, cfg.d_ff))


def n_shared_applications(cfg) -> int:
    """The hybrid's applications of its shared block a pass: after every
    layer i with i % attn_every == attn_every - 1 (``models.zamba2``
    re-exports it; kept here so counting imports no torch)."""
    return sum(i % cfg.attn_every == cfg.attn_every - 1
               for i in range(cfg.n_layers))


def _conv_per_point(cfg) -> int:
    """Weights of the AtacWorks stack per tap and input column: stem C,
    22 body convs C*C, 2 heads C."""
    C = cfg.conv_channels
    return C + 2 * N_RES_BLOCKS * C * C + 2 * C


def param_count(cfg, active_only: bool = False) -> int:
    """The parameters by JAX's count (no norms or biases); with
    ``active_only`` an MoE model's a token uses: ``top_k`` of its routed
    experts a layer."""
    if cfg.family == "conv":
        return cfg.conv_filter * _conv_per_point(cfg)
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "vlm"):
        return emb + cfg.n_layers * (_attn_params(cfg)
                                     + _mlp_params(cfg, cfg.d_ff))
    if cfg.family == "moe":
        nd = cfg.moe.first_dense_layers
        return (emb + cfg.n_layers * _attn_params(cfg)
                + nd * _mlp_params(cfg, cfg.moe.d_ff_dense)
                + (cfg.n_layers - nd) * _moe_layer_params(cfg, active_only))
    if cfg.family == "ssm":
        return emb + cfg.n_layers * _ssm_block_params(cfg)
    if cfg.family == "hybrid":
        return (emb + cfg.n_layers * _ssm_block_params(cfg)
                + _shared_block_params(cfg))
    if cfg.family == "encdec":
        return emb + _encoder_params(cfg) + cfg.n_layers * (
            _attn_params(cfg) + _cross_params(cfg)
            + _mlp_params(cfg, cfg.d_ff))
    raise ValueError(f"family {cfg.family!r} is not ported")


def active_param_count(cfg) -> int:
    """The parameters a token uses (``param_count`` for every family but
    MoE)."""
    return param_count(cfg, active_only=True)


def _cross_params(cfg) -> int:
    """A decoder layer's cross-attention: four projections over all H
    heads."""
    return 4 * cfg.d_model * cfg.n_heads * cfg.head_dim


def _encoder_params(cfg) -> int:
    """The encoder's layers (JAX's count: projections and MLP, no norms
    or biases)."""
    return cfg.n_encoder_layers * (_attn_params(cfg)
                                   + _mlp_params(cfg, cfg.d_ff))


def _attn_seq_flops(cfg, B: int, T: int, causal: bool = True) -> int:
    """QK^T + AV flops of one full-sequence pass (dense and VLM; hybrid: the
    shared block's applications, JAX's count, without the SSD's; encdec:
    the encoder's non-causal self-attention over its frames, the
    decoder's causal one over T tokens and its cross-attention), or the
    SSD's intra-chunk and state flops (ssm), all layers.  MLA counts the
    mean of its qk (nope + rope) and v widths as the head dim, as JAX's
    count does."""
    factor = 0.5 if causal else 1.0
    if cfg.family in ("dense", "moe", "vlm"):
        a = cfg.mla
        hd = ((a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim) / 2
              if a else cfg.head_dim)
        return int(4 * B * T * T * cfg.n_heads * hd * factor * cfg.n_layers)
    if cfg.family == "hybrid":
        return int(4 * B * T * T * cfg.n_heads * cfg.head_dim * factor
                   * n_shared_applications(cfg))
    if cfg.family == "encdec":
        Hd, Te = cfg.n_heads * cfg.head_dim, cfg.encoder_width
        enc = 4 * B * Te ** 2 * Hd
        dec_self = 4 * B * T * T * Hd * 0.5
        dec_cross = 4 * B * T * Te * Hd
        return int(enc * cfg.n_encoder_layers
                   + (dec_self + dec_cross) * cfg.n_layers)
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
    n = active_param_count(cfg)
    if shape.kind == "train":
        return float(6 * n * B * T + 3 * _attn_seq_flops(cfg, B, T))
    if shape.kind == "prefill":
        return float(2 * n * B * T + _attn_seq_flops(cfg, B, T))
    if cfg.family in ("ssm", "hybrid"):  # decode: one token, the states
        s = cfg.ssm
        _, H = _ssm_dims(cfg)
        state = 6 * B * H * s.head_dim * s.d_state * cfg.n_layers
        if cfg.family == "hybrid":  # and each application's K/V slot
            state += (4 * B * T * cfg.n_heads * cfg.head_dim
                      * n_shared_applications(cfg))
        return float(2 * n * B + state)
    if cfg.mla is not None:  # the plain decode re-expands the latent cache
        a = cfg.mla
        expand = (2 * B * T * a.kv_lora_rank * cfg.n_heads
                  * (a.qk_nope_head_dim + a.v_head_dim))
        attn = 2 * B * T * cfg.n_heads * (
            a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
        return float(2 * n * B + (expand + attn) * cfg.n_layers)
    # dense, moe, vlm and encdec decode: one token, attention reads the whole
    # cache
    # (and the encoder-decoder's cross K/V)
    attn = 4 * B * T * cfg.n_heads * cfg.head_dim * cfg.n_layers
    if cfg.family == "encdec":
        attn += (4 * B * cfg.encoder_width * cfg.n_heads * cfg.head_dim
                 * cfg.n_layers)
    return float(2 * n * B + attn)


def decode_cache_bytes(cfg, batch: int, seq_len: int,
                       cache_itemsize: int = 2) -> float:
    """Least cache traffic of one decode step that leaves ``seq_len``
    positions in the cache: the SSM's conv window (``cache_itemsize``
    bytes an element; a hybrid's is fp32 whatever the cache's dtype) and
    fp32 states, each read and written whole; or the KV rows
    (``cache_itemsize``), ``seq_len - 1`` read and the new one written, a
    hybrid's in each application's slot, and an encoder-decoder's cross
    K/V (``encoder_width`` rows of all H heads a layer) read; an MLA
    model's compressed rows (the latent and the rotary key)."""
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner, H = _ssm_dims(cfg)
        window = (s.conv_width - 1) * (d_inner + 2 * s.n_groups * s.d_state)
        window_bytes = 4 if cfg.family == "hybrid" else cache_itemsize
        state = window_bytes * window + 4 * H * s.head_dim * s.d_state
        total = 2 * batch * state * cfg.n_layers
        if cfg.family == "hybrid":
            total += (cache_itemsize * batch * seq_len * cfg.n_kv_heads * 2
                      * cfg.head_dim * n_shared_applications(cfg))
        return float(total)
    if cfg.mla is not None:
        a = cfg.mla
        return float(cache_itemsize * batch * seq_len * (
            a.kv_lora_rank + a.qk_rope_head_dim) * cfg.n_layers)
    rows = seq_len * cfg.n_kv_heads
    if cfg.family == "encdec":
        rows += cfg.encoder_width * cfg.n_heads
    return float(cache_itemsize * batch * rows * 2 * cfg.head_dim
                 * cfg.n_layers)


def hbm_bytes_decode(cfg, shape, cache_itemsize: int = 2) -> float:
    """Least device-memory traffic of one decode step: the bf16
    parameters a token uses (an MoE model's active ones, as if the batch
    shared one token's experts), of an untied embedding only the batch's
    rows, and ``decode_cache_bytes`` at ``shape.seq_len``; an
    encoder-decoder's decode reads no encoder weight.  JAX's count reads
    the whole untied table and the encoder's weights, and leaves out the
    conv window and the cross K/V."""
    B, T = shape.global_batch, shape.seq_len
    p_bytes = 2 * active_param_count(cfg)
    if cfg.family == "encdec":
        p_bytes -= 2 * _encoder_params(cfg)
    if cfg.family != "conv" and not cfg.tie_embeddings:  # a row lookup
        p_bytes -= 2 * (cfg.vocab_size - B) * cfg.d_model
    return float(p_bytes + decode_cache_bytes(cfg, B, T, cache_itemsize))


def model_bytes(cfg, shape) -> float:
    """Least device-memory traffic of one step.  train: bf16 parameters
    read, fp32 gradients, AdamW's moments read and written, parameters
    written, one activations pass; prefill: parameters and activations;
    decode: ``hbm_bytes_decode``, with an MoE model's every expert (JAX's
    count: a batch's ``global_batch * top_k`` selections touch about all
    of them)."""
    if shape.kind == "decode":
        return hbm_bytes_decode(cfg, shape) + 2 * (
            param_count(cfg) - active_param_count(cfg))
    B, T = shape.global_batch, shape.seq_len
    act = 2 * B * T * max(cfg.d_model, 1)
    if cfg.family == "conv":
        act = 4 * B * T * cfg.conv_channels
    p = param_count(cfg)
    if shape.kind == "train":
        return float(2 * p + 4 * p + 2 * 2 * 4 * p + 2 * p + 6 * act)
    return float(2 * p + 2 * act)
