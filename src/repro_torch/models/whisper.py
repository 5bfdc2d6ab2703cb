"""Whisper-large-v3 (arXiv:2212.04356), the encoder-decoder family
(counterpart of ``repro/models/whisper.py``).

The encoder takes precomputed frame embeddings (B, W_enc, D): sinusoidal
positions added, then layers of ``x + attn(norm(x))`` (non-causal
self-attention) and ``x + mlp(norm(x))``, then ``enc_norm``.  Each decoder
layer adds, between its causal self-attention and its MLP, a
cross-attention over the encoder's states: K without a bias, V, Q and O
with theirs, over all ``n_heads`` heads (the config's ``n_kv_heads``
groups the self-attention only).  Self-attention runs through the flash
kernels (``kernels/flash_attention.py``) when ``cfg.attn_impl == "flash"``
and through the plain chunked ``common.gqa_attention`` otherwise; the
cross-attention is always the plain ``gqa_attention``, as in the JAX
package.  The decoder's token embedding adds a learned position table.

The conv frontend (``conv_frontend``) makes the frames from a (B, 128, T)
mel spectrogram with two SAME convolutions of 3 taps, bias and GELU fused
(128 -> D, then D -> D, every other column kept: Whisper's stride 2)
through ``ops.conv1d``, which on the card runs the paper's kernel
``conv1d_fwd`` (and, under autograd, ``conv1d_bwd_weight`` and the
bwd-data pass).  As in the JAX package its parameters are part of the
model, and ``forward`` takes the frames and never reads them: a training
step gives them zero gradients.

Parameters are the JAX tree's leaves under its dotted keys
(``embed.tok``, ``embed.pos``, ``frontend.conv1_w``, ``enc_layers.attn.wq``
(L_enc, D, H * hd), ``enc_norm.scale``, ``dec_layers.cross.bv``,
``final_norm.bias``, ``unembed``), so ``convert.params_from_jax`` carries a
JAX tree over unchanged (``models/transformer.py``).

Serving: ``init_cache`` holds the decoder's self-attention K/V (L, B,
Tmax, KV, hd) and the cross-attention K/V (L, B, Te, H, hd).  The JAX
package documents the cross K/V as precomputed from the frames but never
fills them (its launcher decodes against zeros); ``fill_cross_cache``
fills them from ``encode`` and ``cross_kv``, which is what the JAX
functions give when composed.  ``decode_step`` then runs one token
through every decoder layer, updating the self-attention cache in place;
it runs no kernel.

Tensor-parallel serving: a rank's model (``models.local_model``, ``tp``
its ``sharding.ModelGroup``) runs the encoder and decoder on its heads,
as ``models/common.py``'s ``tp=`` paths do: Q, K, V and the MLP's up
projection (and ``bq``, ``bk``, ``bv``, ``b_up``) are its column blocks,
``wo`` and ``w_down`` row blocks summed over the group before ``bo`` and
``b_down`` are added once.  The heads are ``sharding.head_blocks``'
(Whisper-large-v3's 20 over 8 ranks: 3, 3, 3, 3, 2, 2, 2, 2); the
cross-attention takes the rank's query heads, and so does its cache
(``init_cache(..., mp=, rank=)``: the rank's KV heads of the
self-attention K/V, its query heads of the cross K/V).  The decoder's
learned position table stays whole; the token table and the logits are
vocabulary blocks, as in ``models/transformer.py``.  The conv frontend
is on no serving path: a rank keeps its blocks of it and never runs
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import sharding, transformer

N_MELS = 128
ENC, DEC = "enc_layers.", "dec_layers."


def frontend_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The conv frontend's leaves (JAX's ``init_frontend``): taps (S=3, K,
    C) scaled by (3 C) ** -0.5, zero biases."""
    D = cfg.d_model
    return {"conv1_w": ((3, D, N_MELS), "normal", (3 * N_MELS) ** -0.5),
            "conv1_b": ((D,), "zeros", 0.0),
            "conv2_w": ((3, D, D), "normal", (3 * D) ** -0.5),
            "conv2_b": ((D,), "zeros", 0.0)}


def cross_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One decoder layer's cross-attention leaves: four projections over
    all H heads, biases on Q, V and O."""
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": ((D, H * hd), "normal", D ** -0.5),
            "wk": ((D, H * hd), "normal", D ** -0.5),
            "wv": ((D, H * hd), "normal", D ** -0.5),
            "wo": ((H * hd, D), "normal", (H * hd) ** -0.5),
            "bq": ((H * hd,), "zeros", 0.0),
            "bv": ((H * hd,), "zeros", 0.0),
            "bo": ((D,), "zeros", 0.0)}


def _leaf_spec(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """Every leaf of the model: ``key -> (shape, init, scale)``."""
    norm = transformer.norm_leaves(cfg)
    layer = transformer.layer_leaves(cfg)
    dec = dict(layer)
    dec.update({f"cross_norm.{k}": v for k, v in norm.items()})
    dec.update({f"cross.{k}": v for k, v in cross_leaves(cfg).items()})
    spec = {f"embed.{k}": v for k, v in cm.embedding_leaves(cfg).items()}
    spec.update({f"frontend.{k}": v for k, v in frontend_leaves(cfg).items()})
    spec.update(transformer.stacked_leaves(ENC, cfg.n_encoder_layers, layer))
    spec.update({f"enc_norm.{k}": v for k, v in norm.items()})
    spec.update(transformer.stacked_leaves(DEC, cfg.n_layers, dec))
    spec.update({f"final_norm.{k}": v for k, v in norm.items()})
    spec["unembed"] = ((cfg.d_model, cfg.padded_vocab), "normal",
                       cfg.d_model ** -0.5)
    return spec


class Whisper(transformer.Transformer):
    """The encoder-decoder; ``forward(tokens, frames=)`` is :func:`forward`.
    Its parameters are the JAX tree's leaves under their dotted keys."""

    def forward(self, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None,
                extra_embeds: torch.Tensor | None = None,
                last_only: bool = False,
                hidden_only: bool = False) -> torch.Tensor:
        return forward(self, tokens, frames=frames,
                       extra_embeds=extra_embeds, last_only=last_only,
                       hidden_only=hidden_only)


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> Whisper:
    """The model with weights drawn on the host from a generator seeded
    with ``seed`` (``transformer.draw_leaves``), by the JAX package's
    distributions: normal projections scaled by fan-in ** -0.5, both
    embedding tables by 0.02, the frontend's taps as ``frontend_leaves``,
    zero biases, unit norm scales."""
    if cfg.family != "encdec":
        raise ValueError(f"Whisper builds the 'encdec' family, not "
                         f"{cfg.family!r}")
    return Whisper(cfg, transformer.draw_leaves(_leaf_spec(cfg), cfg,
                                                seed=seed, device=device))


# --- the conv frontend -------------------------------------------------------

def conv_frontend(p: dict, mel: torch.Tensor, cfg, *,
                  backend: str | None = None) -> torch.Tensor:
    """mel (B, 128, T) -> frame embeddings (B, T // 2, D) in mel's dtype.
    ``p`` holds the frontend's leaves by name (``conv1_w``, ``conv1_b``,
    ``conv2_w``, ``conv2_b``; ``dict(model.frontend.named_parameters())``).
    Both convolutions are SAME with bias and GELU in the kernel's fused
    epilogue; stride 2 is the second one's every other column, as in the
    JAX package (no strided kernel).  ``backend`` is ``ops.conv1d``'s."""
    h = ops.conv1d(mel, p["conv1_w"], bias=p["conv1_b"], activation="gelu",
                   padding="SAME", backend=backend)
    h = ops.conv1d(h, p["conv2_w"], bias=p["conv2_b"], activation="gelu",
                   padding="SAME", backend=backend)[:, :, ::2]
    return h.to(mel.dtype).transpose(1, 2)


# --- encoder and decoder -----------------------------------------------------

def _norm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return cm.apply_norm(p["scale"], x, cfg, p.get("bias"))


def cross_kv(p: dict, enc: torch.Tensor, cfg
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder states (B, Te, D) -> cross-attention k and v (B, Te, H,
    hd) (H that of ``p``'s blocks: a tensor-parallel rank's query heads);
    k has no bias."""
    B, Te, _ = enc.shape
    hd = cfg.head_dim
    k = (enc @ p["wk"]).reshape(B, Te, -1, hd)
    v = (enc @ p["wv"] + p["bv"]).reshape(B, Te, -1, hd)
    return k, v


def cross_attention(p: dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """x (B, T, D) attends to every key of k, v (B, Te, H, hd): the plain
    ``gqa_attention`` (G = 1), whatever ``cfg.attn_impl`` is; with ``tp``
    on the rank's heads, ``wo``'s product summed over the group before
    ``bo``."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"] + p["bq"]).reshape(B, T, -1, hd)
    o = cm.gqa_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return cm.row_parallel(o.reshape(B, T, -1) @ p["wo"], p["bo"], tp)


def _layers(model: Whisper, prefix: str):
    """The stack's leaf keys below ``prefix`` and each layer's slices."""
    keys, stacked = transformer._stacked(model, prefix)
    return keys, zip(*(p.unbind(0) for p in stacked))


def encode(model: Whisper, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, W_enc, D) -> the encoder's states (B, W_enc, D), in the
    frames' dtype.  With ``cfg.remat`` each layer's activations are
    recomputed in the backward.  A tensor-parallel rank's model
    (``model.tp``) runs its heads and MLP columns."""
    cfg, tp, ds = model.cfg, model.tp, model.ds
    T = frames.shape[1]
    x = frames + cm.sinusoidal_positions(T, cfg.d_model,
                                         frames.device).to(frames.dtype)
    positions = torch.arange(T, device=frames.device)
    keys, layers = _layers(model, ENC)
    full = [ENC + k for k in keys]

    def layer(x, *leaves):
        lp = transformer._nest(keys, cm.gather_layer(ds, full, leaves))
        h = _norm(lp["attn_norm"], x, cfg)
        x = x + cm.attention_block(lp["attn"], h, cfg, positions,
                                   causal=False, tp=tp)
        return x + cm.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg),
                                cfg, tp=tp)

    step = cm.maybe_remat(layer, cfg)
    for lp in layers:
        x = step(x, *lp)
    return cm.apply_norm(model.enc_norm.scale, x, cfg, model.enc_norm.bias)


def forward(model: Whisper, tokens: torch.Tensor, *,
            frames: torch.Tensor | None = None,
            extra_embeds: torch.Tensor | None = None,
            last_only: bool = False, hidden_only: bool = False
            ) -> torch.Tensor:
    """Training and prefill: tokens (B, T) int and frames (B, W_enc, D)
    (``extra_embeds`` is the same argument under the VLM's name, as in the
    JAX package) -> fp32 logits (B, T, padded_vocab), the padded columns
    at ``common.NEG_INF``.  ``last_only`` and ``hidden_only`` as in
    ``transformer.forward``; a tensor-parallel rank's model (``model.tp``)
    runs its blocks."""
    cfg, tp, ds = model.cfg, model.tp, model.ds
    frames = frames if frames is not None else extra_embeds
    if frames is None:
        raise ValueError("the encoder-decoder needs frames (B, W_enc, D)")
    enc = encode(model, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    tok, pos = cm.gathered(model, ["embed.tok", "embed.pos"])
    x = cm.embed_tokens(tok, tokens, cfg, pos=pos, positions=positions,
                        tp=tp)
    keys, layers = _layers(model, DEC)
    full = [DEC + k for k in keys]

    def layer(x, enc, *leaves):
        lp = transformer._nest(keys, cm.gather_layer(ds, full, leaves))
        h = _norm(lp["attn_norm"], x, cfg)
        x = x + cm.attention_block(lp["attn"], h, cfg, positions,
                                   causal=True, tp=tp)
        h = _norm(lp["cross_norm"], x, cfg)
        k, v = cross_kv(lp["cross"], enc, cfg)
        x = x + cross_attention(lp["cross"], h, k, v, cfg, tp)
        return x + cm.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg),
                                cfg, tp=tp)

    step = cm.maybe_remat(layer, cfg)
    for lp in layers:
        x = step(x, enc, *lp)
    if last_only:
        x = x[:, -1:]
    return transformer._final(model, x, hidden_only, tok)


# --- decode (self-attention KV cache, cross-attention K/V) -------------------

def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu",
               enc_len: int | None = None, mp: int = 1,
               rank: int = 0) -> dict:
    """The JAX package's cache, zeros in ``dtype``: ``k``, ``v`` (L, B,
    max_len, KV, hd) and ``cross_k``, ``cross_v`` (L, B, Te, H, hd), Te
    being ``enc_len`` or ``cfg.encoder_width``.  ``fill_cross_cache``
    fills the cross K/V from the frames.  ``mp`` and ``rank``: model rank
    ``rank`` of ``mp``'s, the heads of its head block
    (``sharding.head_blocks``): its KV heads of the self-attention's, its
    query heads of the cross-attention's."""
    L, hd = cfg.n_layers, cfg.head_dim
    q, kv = sharding.head_blocks(cfg, mp)[rank]
    Te = enc_len or cfg.encoder_width

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": zeros(L, batch, max_len, len(kv), hd),
            "v": zeros(L, batch, max_len, len(kv), hd),
            "cross_k": zeros(L, batch, Te, len(q), hd),
            "cross_v": zeros(L, batch, Te, len(q), hd)}


@torch.inference_mode()
def fill_cross_cache(model: Whisper, cache: dict,
                     frames: torch.Tensor) -> dict:
    """Write every decoder layer's cross-attention K/V of ``encode(frames)``
    into ``cache["cross_k"]`` and ``cache["cross_v"]`` in place (cast to
    the cache's dtype) and return the cache."""
    cfg = model.cfg
    Te = cache["cross_k"].shape[2]
    if tuple(frames.shape[:2]) != (cache["cross_k"].shape[1], Te):
        raise ValueError(f"frames {tuple(frames.shape)} do not fit the "
                         f"cache's (batch, Te) = "
                         f"{tuple(cache['cross_k'].shape[1:3])}")
    enc = encode(model, frames)
    keys, layers = _layers(model, DEC)
    cross = [i for i, k in enumerate(keys) if k.startswith("cross.")]
    for layer, lp in enumerate(layers):
        lp = cm.gather_layer(model.ds, [DEC + keys[i] for i in cross],
                             [lp[i] for i in cross])
        k, v = cross_kv(transformer._nest([keys[i] for i in cross], lp)[
            "cross"], enc, cfg)
        cache["cross_k"][layer].copy_(k)
        cache["cross_v"][layer].copy_(v)
    return cache


def decode_step(model: Whisper, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) int at position ``pos`` (the
    self-attention cache's valid length) -> (fp32 logits (B, 1,
    padded_vocab), cache), each layer's k and v written into the cache at
    ``pos`` in place; the cross K/V are read in x's dtype.  A
    tensor-parallel rank's model runs its blocks on its cache; a data
    rank's (``model.ds``) gathers each layer's leaves, and the tables,
    where they are read."""
    cfg, tp = model.cfg, model.tp
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"position {pos} is past the cache's "
                         f"{cache['k'].shape[2]} slots")
    tok, pos_table = cm.gathered(model, ["embed.tok", "embed.pos"])
    x = cm.embed_tokens(tok, tokens, cfg, pos=pos_table,
                        positions=torch.full((1,), pos,
                                             device=tokens.device), tp=tp)
    keys, layers = _layers(model, DEC)
    full = [DEC + k for k in keys]
    caches = zip(*(cache[k].unbind(0)
                   for k in ("k", "v", "cross_k", "cross_v")))
    for lp, (ck, cv, xk, xv) in zip(layers, caches):
        lp = transformer._nest(keys, cm.gather_layer(model.ds, full, lp))
        h = _norm(lp["attn_norm"], x, cfg)
        x = x + cm.attention_decode(lp["attn"], h, cfg, ck, cv, pos, tp)
        h = _norm(lp["cross_norm"], x, cfg)
        x = x + cross_attention(lp["cross"], h, xk.to(x.dtype),
                                xv.to(x.dtype), cfg, tp)
        x = x + cm.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg), cfg,
                             tp=tp)
    return transformer._final(model, x, tok=tok), cache
