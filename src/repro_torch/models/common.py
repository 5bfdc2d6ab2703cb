"""Shared language-model pieces the ported families read (counterpart of
the matching parts of ``repro/models/common.py``): the RMS and layer
norms, rotary embeddings, grouped-query attention (the chunked plain
path and the flash kernels) and its single-token decode against a KV
cache, the MLPs, token embedding, the unembedding
with its vocabulary padding masked, the learned and sinusoidal position
embeddings, and activation rematerialisation.

The JAX package's cast points are kept: norms, rotary embeddings, the
softmax and the MLP's activation run in fp32 and are cast back to the
activations' dtype; projections and their biases stay in the parameters'
dtype.  Layouts are the JAX package's: q (B, T, H, hd), k and v
(B, T, KV, hd) with h = kv * G + g.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30  # a masked score, and the logit of a padded vocab column


# --- norms -------------------------------------------------------------------

def init_norm(cfg, d: int, dtype: torch.dtype) -> dict:
    """``{"scale": ones(d)}``, and ``"bias": zeros(d)`` for a layer norm."""
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {cfg.norm!r}")
    p = {"scale": torch.ones(d, dtype=dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype)
    return p


def apply_norm(scale: torch.Tensor, x: torch.Tensor, cfg,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The config's norm over the last axis in fp32 (a layer norm takes
    its ``bias``), cast back to x's dtype."""
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * scale.float() + bias.float()).to(x.dtype)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """RMS norm over the head_dim axis of each head (Qwen3's qk_norm)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# --- rotary embeddings (GPT-NeoX half rotation) -------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, T, H, hd), positions (B, T) or (T,): the first and second
    halves of each head rotated by position * freq, in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention -----------------------------------------------------------------

def attention_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The attention block's leaves: ``name -> (shape, init, scale)``, init
    being ``"normal"`` (times scale), ``"zeros"`` or ``"ones"``."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ((D, H * hd), "normal", D ** -0.5),
         "wk": ((D, KV * hd), "normal", D ** -0.5),
         "wv": ((D, KV * hd), "normal", D ** -0.5),
         "wo": ((H * hd, D), "normal", (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=((H * hd,), "zeros", 0.0), bk=((KV * hd,), "zeros", 0.0),
                 bv=((KV * hd,), "zeros", 0.0))
    if cfg.attn_out_bias:
        p["bo"] = ((D,), "zeros", 0.0)
    if cfg.qk_norm:
        p.update(q_norm=((hd,), "ones", 0.0), k_norm=((hd,), "ones", 0.0))
    return p


def _qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, T, D) -> q (B, T, H, hd), k and v (B, T, KV, hd): projections
    (+ biases), qk_norm, rotary embeddings."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, chunk: int = 0,
                  kv_len: torch.Tensor | int | None = None) -> torch.Tensor:
    """Grouped-query attention in plain PyTorch (the ``chunked`` path, which
    the JAX package leaves to XLA).  q (B, Tq, H, hd), k and v (B, Tk, KV,
    hd) -> (B, Tq, H, vd).  With ``chunk`` > 0 and Tq a multiple of it
    larger than it, the queries go ``chunk`` at a time, so the fp32 scores
    are (chunk, Tk) and never (Tq, Tk).  ``kv_len`` masks the keys at and
    past it (a decode cache's valid length)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Tq, KV, G, hd)
    q_positions = torch.arange(Tq, device=q.device)
    kv_positions = torch.arange(Tk, device=q.device)
    kf = k.float()

    def blk(q_blk, qpos_blk):
        s = torch.einsum("btkgh,bskh->bkgts", q_blk.float() * scale, kf)
        mask = torch.ones((q_blk.shape[1], Tk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos_blk[:, None] >= kv_positions[None, :]
        if kv_len is not None:
            mask &= (kv_positions < kv_len)[None, :]
        s = torch.where(mask, s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        return torch.einsum("bkgts,bskh->btkgh", a.to(v.dtype), v)

    if chunk and Tq > chunk and Tq % chunk == 0:
        o = torch.cat([blk(qg[:, i:i + chunk], q_positions[i:i + chunk])
                       for i in range(0, Tq, chunk)], dim=1)
    else:
        o = blk(qg, q_positions)
    return o.reshape(B, Tq, H, vd)


def flash_or_phantom(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                     *, causal: bool) -> torch.Tensor:
    """Attention through the flash kernels: q (B, T, H, hd) grouped to
    (B, T, KV, G, hd) as a view, the JAX package's query tile
    ``min(attn_chunk or 256, T)`` passed on.  The JAX package's
    ``flash_phantom`` branch (a roofline probe) is not ported."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    o = flash_attention(qg, k, v, causal, min(cfg.attn_chunk or 256, T))
    return o.reshape(B, T, H, hd)


def attention_block(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill), x (B, T, D)."""
    q, k, v = _qkv(p, x, cfg, positions)
    if cfg.attn_impl == "flash":
        o = flash_or_phantom(q, k, v, cfg, causal=causal)
    elif cfg.attn_impl == "chunked":
        o = gqa_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    o = o.reshape(*x.shape[:2], -1) @ p["wo"]
    if cfg.attn_out_bias:
        o = o + p["bo"]
    return o


def attention_decode(p: dict, x: torch.Tensor, cfg, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token self-attention.  x (B, 1, D); cache_k and cache_v
    (B, Tmax, KV, hd) are one layer's slices of the KV cache; ``pos`` is
    the token's position, which is the cache's valid length before it.
    k and v are written into the cache at ``pos`` (in place, in the
    cache's dtype) and the query attends to positions 0..pos.

    The JAX package's dtype flow is kept: the softmax weights take the
    cache's dtype (``a.to(v.dtype)``), and ``o @ wo`` promotes as JAX's
    matmul does, so an fp32 cache with bf16 weights gives an fp32 output
    (the JAX package's scan then refuses the fp32 residual; the port's
    launcher runs such a model with a cache of the model's dtype)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, torch.full((B, 1), pos, device=x.device))
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    o = gqa_attention(q, cache_k, cache_v, causal=False, kv_len=pos + 1)
    o = o.reshape(B, 1, -1)
    wo = p["wo"]
    dt = torch.promote_types(o.dtype, wo.dtype)
    o = o.to(dt) @ wo.to(dt)
    if cfg.attn_out_bias:
        o = o + p["bo"]
    return o


# --- MLP -------------------------------------------------------------------------

def mlp_leaves(cfg, d_ff: int | None = None
               ) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The MLP's leaves, as ``attention_leaves``, of width ``d_ff``
    (default ``cfg.d_ff``; JAX's ``init_mlp(..., d_ff=)``: an MoE model's
    dense layers and shared experts have their own)."""
    D, Fd = cfg.d_model, cfg.d_ff if d_ff is None else d_ff
    if cfg.mlp_act == "swiglu":
        p = {"w_gate": ((D, Fd), "normal", D ** -0.5),
             "w_up": ((D, Fd), "normal", D ** -0.5)}
    elif cfg.mlp_act == "gelu":
        p = {"w_up": ((D, Fd), "normal", D ** -0.5)}
    else:
        raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")
    p["w_down"] = ((Fd, D), "normal", Fd ** -0.5)
    if cfg.mlp_bias:
        p.update(b_up=((Fd,), "zeros", 0.0), b_down=((D,), "zeros", 0.0))
    return p


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU or GELU (``jax.nn.gelu``'s default tanh form) MLP: the
    activation in fp32, the biases in the parameters' dtype."""
    if cfg.mlp_act == "swiglu":
        h = F.silu((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    o = h @ p["w_down"]
    if "b_down" in p:
        o = o + p["b_down"]
    return o


# --- embedding, unembedding, remat ----------------------------------------------

def sinusoidal_positions(T: int, d: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """(T, d) fp32 sinusoids: sin at the even columns, cos at the odd ones,
    position t times exp(-ln(10000) i / d) for column pair i (Whisper's
    encoder positions)."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-torch.log(torch.tensor(10000.0)) / d))
    pe = torch.zeros((T, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def embedding_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The embedding's leaves, as ``attention_leaves``: the token table and,
    for learned positions, a table of ``min(max_position, 65536)`` rows."""
    p = {"tok": ((cfg.padded_vocab, cfg.d_model), "normal", 0.02)}
    if cfg.pos_embedding == "learned":
        p["pos"] = ((min(cfg.max_position, 1 << 16), cfg.d_model), "normal",
                    0.02)
    return p


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor, cfg, *,
                 pos: torch.Tensor | None = None,
                 positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of the (padded_vocab, d_model) table for (B, T) token ids, plus
    the position embedding: rows ``positions`` (default 0..T-1) of the
    learned table ``pos``, or the sinusoids of 0..T-1 in x's dtype (rotary
    embeddings act inside attention; none add here)."""
    if cfg.pos_embedding not in ("none", "rope", "learned", "sinusoidal"):
        raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r}")
    x = F.embedding(tokens, tok)
    if cfg.pos_embedding == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + pos[positions]
    elif cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(tokens.shape[-1], cfg.d_model,
                                     tokens.device).to(x.dtype)
    return x


def logits_from_hidden(tok: torch.Tensor, unembed: torch.Tensor | None,
                       x: torch.Tensor, cfg) -> torch.Tensor:
    """fp32 logits (B, T, padded_vocab) from the final hidden state; the
    columns past ``vocab_size`` are ``NEG_INF``, so they take no
    probability and get no gradient."""
    w = tok.t() if cfg.tie_embeddings else unembed
    logits = (x @ w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def maybe_remat(fn, cfg):
    """``fn`` itself, or with ``cfg.remat`` a function that keeps none of
    ``fn``'s activations and recomputes them in the backward (JAX's
    ``nothing_saveable`` policy; the ``"dots"`` policy is not ported).
    Where autograd records nothing (serving, under ``inference_mode``)
    the function runs once, as it is."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported to repro_torch "
            "yet: only 'nothing' is (ROADMAP.md queue A)")

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return remat
