"""Multi-head Latent Attention, DeepSeek-V3's (arXiv:2412.19437;
counterpart of ``repro/models/mla.py``).

Queries go through a low-rank bottleneck (``q_lora_rank``); keys and
values come from one ``kv_lora_rank`` latent ``c_kv`` per position, each
head's key of ``qk_nope_head_dim`` columns expanded from it by ``kv_up``
and joined by a rotary key of ``qk_rope_head_dim`` columns that all heads
share.  The decode cache holds only (``c_kv``, ``k_rope``), the paper's
compressed cache.

At attention time MLA is multi-head attention (KV = H, G = 1) with qk
heads of nope + rope (192 at full width) and v heads of 128.  With
``attn_impl == "flash"`` v goes to the flash kernels padded with zeros to
the qk width and the output is sliced back (JAX's ``_flash_mla``), so
one head dim (192) runs through every product of ``flash_fwd`` and
``flash_bwd``; with ``"chunked"`` the plain ``common.gqa_attention``
takes the two widths as they are.

The decode runs no kernel, as in the JAX package: the plain branch
re-expands the cache through ``kv_up`` at each step; the absorbed one
(``absorb=True``) folds ``kv_up``'s key half into the query and its value
half into the output, so the scores and the weighted sum are taken in the
latent space, in fp32 as JAX takes them.  The absorbed branch reads
``kv_up``'s columns as the forward and the plain branch do, each head's
nope key then its value, so the two branches compute one function; JAX's
absorbed branch reads the first H * nope columns as every head's key and
the rest as every head's value, which at H > 1 is another function of
the same weights (ROADMAP.md queue C).  Both read the cache's first
``pos + 1`` positions only (JAX masks the rest: those keys take weight
exactly 0 there).  The JAX package's ``flash_phantom`` branch (a
roofline probe) is not ported.

Tensor parallelism (serving, ``tp`` a ``sharding.ModelGroup``): a rank
holds ``q_up``'s and ``kv_up``'s column blocks, whole heads each (a
head's columns are contiguous, ``_expand_kv``'s layout), and ``wo``'s row
block, whose product is summed over the group; ``q_down``, ``kv_down``
and the norms are replicated, so every rank computes the whole latent.
The head count is read from the blocks.  JAX's ``cache_pspecs`` shards
the latent ``c_kv`` on its rank dimension (``sharding.py:206-208``); the
explicit form here needs the whole latent for each of the rank's heads,
so each rank keeps ``c_kv`` (and ``k_rope``) whole.  That costs memory
only: mp copies of the compressed cache.  On a data rank of the (dp, mp)
serving mesh both decodes and the block run on the layer's leaves as
``transformer.decode_step`` and ``forward`` gather them over the data
group (the model column's blocks), and the cache holds the data row's
rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common as cm


def mla_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The attention block's leaves (JAX's ``init_mla``), as
    ``common.attention_leaves``: ``q_down`` (D, q_lora), ``q_norm``,
    ``q_up`` (q_lora, H * (nope + rope)), ``kv_down`` (D, kv_lora + rope),
    ``kv_norm``, ``kv_up`` (kv_lora, H * (nope + v)) and ``wo`` (H * v,
    D); projections normal by fan-in ** -0.5, norm scales ones."""
    a = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qh = a.qk_nope_head_dim + a.qk_rope_head_dim
    q_r, kv_r = a.q_lora_rank, a.kv_lora_rank
    return {
        "q_down": ((D, q_r), "normal", D ** -0.5),
        "q_norm": ((q_r,), "ones", 0.0),
        "q_up": ((q_r, H * qh), "normal", q_r ** -0.5),
        "kv_down": ((D, kv_r + a.qk_rope_head_dim), "normal", D ** -0.5),
        "kv_norm": ((kv_r,), "ones", 0.0),
        "kv_up": ((kv_r, H * (a.qk_nope_head_dim + a.v_head_dim)), "normal",
                  kv_r ** -0.5),
        "wo": ((H * a.v_head_dim, D), "normal", (H * a.v_head_dim) ** -0.5),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis in fp32, cast back to x's dtype."""
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _queries(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, T, D) -> q_nope (B, T, H, nope) and q_rope (B, T, H, rope),
    the rotary half rotated."""
    a = cfg.mla
    B, T, _ = x.shape
    q = _rms(x @ p["q_down"], p["q_norm"], cfg.norm_eps) @ p["q_up"]
    q = q.reshape(B, T, -1, a.qk_nope_head_dim + a.qk_rope_head_dim)
    q_nope, q_rope = q.split([a.qk_nope_head_dim, a.qk_rope_head_dim], -1)
    return q_nope, cm.apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, T, D) -> the normed latent c_kv (B, T, kv_lora) and the
    rotated shared key k_rope (B, T, rope)."""
    a = cfg.mla
    c_kv, k_rope = (x @ p["kv_down"]).split(
        [a.kv_lora_rank, a.qk_rope_head_dim], -1)
    c_kv = _rms(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _expand_kv(p: dict, c_kv: torch.Tensor, cfg):
    """c_kv (B, T, kv_lora) -> k_nope (B, T, H, nope) and v (B, T, H, v),
    in the promoted dtype of c_kv and ``kv_up`` (JAX's matmul: an fp32
    cache against bf16 weights gives fp32)."""
    a = cfg.mla
    B, T, _ = c_kv.shape
    w = p["kv_up"]
    dt = torch.promote_types(c_kv.dtype, w.dtype)
    kv = (c_kv.to(dt) @ w.to(dt)).reshape(
        B, T, -1, a.qk_nope_head_dim + a.v_head_dim)
    return kv.split([a.qk_nope_head_dim, a.v_head_dim], -1)


def flash_mla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg
              ) -> torch.Tensor:
    """Causal attention through the flash kernels with qk heads wider than
    v's (JAX's ``_flash_mla``): q, k (B, T, H, qh), v (B, T, H, vh) ->
    (B, T, H, vh).  v is padded with zeros to qh, the kernels run at head
    dim qh with G = 1 (q a (B, T, H, 1, qh) view), and the output's first
    vh columns are kept; the padded columns of o are zeros and take a
    zero cotangent."""
    B, T, H, qh = q.shape
    vh = v.shape[-1]
    vp = F.pad(v, (0, qh - vh))
    o = flash_attention(q.reshape(B, T, H, 1, qh), k, vp, True,
                        min(cfg.attn_chunk or 256, T))
    return o.reshape(B, T, H, qh)[..., :vh]


def mla_attention_block(p: dict, x: torch.Tensor, cfg,
                        positions: torch.Tensor, tp=None) -> torch.Tensor:
    """Full-sequence causal MLA self-attention (train / prefill), x (B, T,
    D) -> (B, T, D); with ``tp`` on the rank's heads, ``wo``'s product
    summed over the group."""
    a = cfg.mla
    B, T, _ = x.shape
    q_nope, q_rope = _queries(p, x, cfg, positions)
    H = q_nope.shape[2]
    c_kv, k_rope = _latent(p, x, cfg, positions)
    k_nope, v = _expand_kv(p, c_kv, cfg)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, a.qk_rope_head_dim)], -1)
    if cfg.attn_impl == "flash":
        o = flash_mla(q, k, v, cfg)
    elif cfg.attn_impl == "chunked":
        o = cm.gqa_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return cm.row_parallel(o.reshape(B, T, H * a.v_head_dim) @ p["wo"],
                           None, tp)


def mla_init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device | str = "cpu", layers: int = 0
                   ) -> dict[str, torch.Tensor]:
    """The compressed cache, zeros: ``{"c_kv": (B, max_len, kv_lora),
    "k_rope": (B, max_len, rope)}``, each with a leading axis of
    ``layers`` when it is not 0 (a layer stack's)."""
    a = cfg.mla
    lead = (layers,) if layers else ()
    return {k: torch.zeros((*lead, batch, max_len, w), dtype=dtype,
                           device=device)
            for k, w in (("c_kv", a.kv_lora_rank),
                         ("k_rope", a.qk_rope_head_dim))}


def mla_attention_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                         pos: int, *, absorb: bool = False,
                         tp=None) -> torch.Tensor:
    """Single-token decode against one layer's compressed cache.  x (B, 1,
    D); ``cache`` holds the layer's ``c_kv`` (B, Tmax, kv_lora) and
    ``k_rope`` (B, Tmax, rope); ``pos`` is the token's position, the
    cache's valid length before it.  The token's latent and rotary key
    are written at ``pos`` (in place, in the cache's dtype) and the query
    attends to positions 0..pos: plainly (the cache expanded through
    ``kv_up``) or, with ``absorb``, in the latent space.  Scores, softmax
    and the weighted sum in fp32, as JAX's; the output cast to x's dtype
    before ``wo``; with ``tp`` on the rank's heads, ``wo``'s product
    summed over the group."""
    a = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)          # (B, 1, H, .)
    H = q_nope.shape[2]
    c_new, kr_new = _latent(p, x, cfg, positions)
    cache["c_kv"][:, pos] = c_new[:, 0]
    cache["k_rope"][:, pos] = kr_new[:, 0]
    c_kv, k_rope = cache["c_kv"][:, :pos + 1], cache["k_rope"][:, :pos + 1]
    scale = (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
    kr32 = k_rope.float()
    if absorb:
        # kv_up's key half folded into the query, its value half into the
        # output: no per-step expansion of the cache.  Each head's columns
        # are its nope key's, then its value's, as _expand_kv reads them
        # (JAX's absorbed branch reads the first H * nope columns as the
        # keys of all heads: another function of the same weights)
        w = p["kv_up"].float().reshape(
            a.kv_lora_rank, H, a.qk_nope_head_dim + a.v_head_dim)
        wk_up, wv_up = w.split([a.qk_nope_head_dim, a.v_head_dim], -1)
        c32 = c_kv.float()
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), wk_up)
        s = torch.einsum("bthr,bsr->bhts", q_lat * scale, c32)
        s = s + torch.einsum("bthe,bse->bhts", q_rope.float() * scale, kr32)
        att = torch.softmax(s, -1)
        o_lat = torch.einsum("bhts,bsr->bthr", att, c32)
        o = torch.einsum("bthr,rhv->bthv", o_lat, wv_up)
    else:
        k_nope, v = _expand_kv(p, c_kv, cfg)                 # (B, S, H, .)
        s = torch.einsum("bthn,bshn->bhts", q_nope.float() * scale,
                         k_nope.float())
        s = s + torch.einsum("bthe,bse->bhts", q_rope.float() * scale, kr32)
        att = torch.softmax(s, -1)
        o = torch.einsum("bhts,bshv->bthv", att, v.float())
    return cm.row_parallel(
        o.reshape(B, 1, H * a.v_head_dim).to(x.dtype) @ p["wo"], None, tp)
