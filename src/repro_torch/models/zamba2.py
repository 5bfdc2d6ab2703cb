"""Zamba2 (arXiv:2411.15242), the hybrid family: a Mamba2 backbone with
one weight-shared transformer block (counterpart of
``repro/models/zamba2.py``).

Each layer is a Mamba2 block (``mamba2.block_fwd`` on the layer's slice of
the stacked ``layers.norm``/``layers.mixer`` leaves, its causal conv
through the depthwise kernels); after every layer ``i`` with ``i %
attn_every == attn_every - 1`` the shared block runs: it reads
``concat(hidden, emb)`` (width 2·D, ``emb`` the embedding output), an
RMS norm over the 2·D, Q, K and V projected from it with rotary
embeddings at ``cfg.rope_theta`` and no biases, causal attention (the
flash kernels for ``cfg.attn_impl == "flash"``, the plain chunked
``common.gqa_attention`` otherwise), ``wo`` back to D into the residual,
then an RMS-normed SwiGLU MLP into the residual.  Its weights are one set
whatever the number of applications, so their gradient is the sum over
the applications, and ``emb``'s reaches the embedding table through every
application beside the residual.  With ``cfg.remat`` the whole layer,
shared block included, is recomputed in the backward (JAX's ``f``).

This is the JAX package's simplification of Zamba2, kept as it is: one
shared block, no per-application LoRA adapters, head_dim 112 at full
width (which the flash kernels take in a tile of 128 columns).

Serving: ``init_cache`` holds the Mamba2 states of every layer (fp32
whatever the cache's dtype, as JAX's) and one K/V slot per application,
(n_app, B, Tmax, KV, hd) in the cache's dtype; ``decode_step`` runs one
token through every layer, writing each application's k and v into its
slot at ``pos`` and updating the Mamba2 states, in place.  It runs no
kernel: the Mamba2 blocks take the recurrent update and the attention is
the plain ``gqa_attention`` over the slot's first ``pos + 1`` rows, as in
the JAX package.

Parameters are the JAX tree's leaves under its dotted keys
(``embed.tok``, ``layers.norm.scale``, ``layers.mixer.in_proj`` (L, D,
d_proj), ``shared.in_norm.scale`` (2·D,), ``shared.wq`` (2·D, H·hd),
``shared.mlp.w_gate``, ``final_norm.scale``, ``unembed``), so
``convert.params_from_jax`` carries a JAX tree over unchanged.

Tensor-parallel serving: a rank's model (``models.local_model``, ``tp``
its ``sharding.ModelGroup``) runs its Mamba2 layers as
``models/mamba2.py`` does and the shared block on its heads: Q, K and V
from the replicated 2·D concat through their column blocks, flash (or
the plain attention) on the rank's heads (``sharding.head_blocks``:
H/N over KV/N at full width), ``wo`` and the MLP's ``w_down``
row-parallel (``common.attention_block``'s and ``apply_mlp``'s sums);
its cache holds the rank's SSM heads and conv channels and its KV heads
of each slot.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import common as cm
from repro_torch.models import mamba2, sharding, transformer
from repro_torch.roofline.flops import n_shared_applications  # noqa: F401


def _applies(cfg, i: int) -> bool:
    """Whether the shared block runs after layer ``i``."""
    return i % cfg.attn_every == cfg.attn_every - 1


def shared_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The shared block's leaves (JAX's ``init_shared_block``), as
    ``common.attention_leaves``: Q, K and V from the 2·D concat, ``wo``
    back to D, a norm over each input, the MLP."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {"in_norm.scale": ((2 * D,), "ones", 0.0),
            "wq": ((2 * D, H * hd), "normal", (2 * D) ** -0.5),
            "wk": ((2 * D, KV * hd), "normal", (2 * D) ** -0.5),
            "wv": ((2 * D, KV * hd), "normal", (2 * D) ** -0.5),
            "wo": ((H * hd, D), "normal", (H * hd) ** -0.5),
            "mlp_norm.scale": ((D,), "ones", 0.0)}
    spec.update({f"mlp.{k}": v for k, v in cm.mlp_leaves(cfg).items()})
    return spec


class Zamba2(transformer.Transformer):
    """The language model; ``forward(tokens)`` is :func:`forward`.  Its
    parameters are the JAX tree's leaves under their dotted keys."""

    def forward(self, tokens: torch.Tensor, *, last_only: bool = False,
                hidden_only: bool = False,
                backend: str | None = None) -> torch.Tensor:
        return forward(self, tokens, last_only=last_only,
                       hidden_only=hidden_only, backend=backend)


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> Zamba2:
    """The model with weights drawn on the host from a generator seeded
    with ``seed``: Mamba2's leaves as ``mamba2.init_params`` draws them
    (``mamba2.draw_leaves``: stacked leaves a layer's slab at a time, each
    leaf moved to ``device`` as it is drawn), then the shared block's by
    the JAX package's distributions (``shared_leaves``: projections
    scaled by fan-in ** -0.5, unit norm scales)."""
    if cfg.family != "hybrid":
        raise ValueError(f"Zamba2 builds the 'hybrid' family, not "
                         f"{cfg.family!r}")
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    leaves = mamba2.draw_leaves(cfg, gen, device)
    for key, (shape, init, scale) in shared_leaves(cfg).items():
        leaves[f"shared.{key}"] = (
            mamba2.normal_leaf(gen, shape, scale, dtype, device)
            if init == "normal"
            else torch.ones(shape, dtype=dtype, device=device))
    return Zamba2(cfg, leaves)


def _shared(model: Zamba2, leaves: dict | None = None) -> dict:
    """The shared block's leaves by their names in the JAX tree, from
    ``leaves`` (state-dict key -> tensor; default: the model's
    parameters)."""
    if leaves is None:
        leaves = dict(model.named_parameters())
    sh = {k[len("shared."):]: t for k, t in leaves.items()
          if k.startswith("shared.")}
    return {"in_norm": sh["in_norm.scale"], "wq": sh["wq"], "wk": sh["wk"],
            "wv": sh["wv"], "wo": sh["wo"],
            "mlp_norm": sh["mlp_norm.scale"],
            "mlp": {k[len("mlp."):]: t for k, t in sh.items()
                    if k.startswith("mlp.")}}


def _shared_qkv(p: dict, xcat: torch.Tensor, cfg, positions: torch.Tensor):
    """xcat (B, T, 2·D) -> q (B, T, H, hd), k and v (B, T, KV, hd): the
    norm over 2·D, the projections (no biases), rotary embeddings (H and
    KV those of ``p``'s blocks: a tensor-parallel rank's heads)."""
    B, T, _ = xcat.shape
    hd = cfg.head_dim
    h = cm.apply_norm(p["in_norm"], xcat, cfg)
    q = (h @ p["wq"]).reshape(B, T, -1, hd)
    k = (h @ p["wk"]).reshape(B, T, -1, hd)
    v = (h @ p["wv"]).reshape(B, T, -1, hd)
    return (cm.apply_rope(q, positions, cfg.rope_theta),
            cm.apply_rope(k, positions, cfg.rope_theta), v)


def _mlp(p: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    return x + cm.apply_mlp(p["mlp"], cm.apply_norm(p["mlp_norm"], x, cfg),
                            cfg, tp=tp)


def shared_block_fwd(p: dict, x: torch.Tensor, emb: torch.Tensor, cfg,
                     positions: torch.Tensor, tp=None) -> torch.Tensor:
    """The shared block over the full sequence: x and emb (B, T, D); with
    ``tp`` on the rank's heads, ``wo`` and ``w_down`` summed over the
    group."""
    q, k, v = _shared_qkv(p, torch.cat([x, emb], dim=-1), cfg, positions)
    if cfg.attn_impl == "flash":
        o = cm.flash_or_phantom(q, k, v, cfg, causal=True)
    elif cfg.attn_impl == "chunked":
        o = cm.gqa_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    o = o.reshape(*x.shape[:2], -1) @ p["wo"]
    x = x + cm.row_parallel(o, None, tp)
    return _mlp(p, x, cfg, tp)


def forward(model: Zamba2, tokens: torch.Tensor, *, last_only: bool = False,
            hidden_only: bool = False,
            backend: str | None = None) -> torch.Tensor:
    """tokens (B, T) int -> fp32 logits (B, T, padded_vocab), the padded
    columns at ``common.NEG_INF``; ``last_only`` keeps the last position
    only (B, 1, ...), the prefill's; with ``hidden_only`` the final-normed
    hidden state (B, T, D) instead.  ``backend`` picks the Mamba2 conv's
    (``None``: the kernels for CUDA tensors, the plain version for CPU
    ones).  A tensor-parallel rank's model (``model.tp``) runs its
    blocks; an FSDP rank's (``model.ds``) gathers each Mamba2 layer's
    leaves inside the layer, and the embedding with the shared block's
    leaves once, at the start (the block's gradient summed over its
    applications before it goes back to the blocks)."""
    cfg, tp, ds = model.cfg, model.tp, model.ds
    keys = ["embed.tok"] + [k for k, _ in model.named_parameters()
                            if k.startswith("shared.")]
    leaves = dict(zip(keys, cm.gathered(model, keys)))
    x = cm.embed_tokens(leaves["embed.tok"], tokens, cfg, tp=tp)
    emb = x
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    shared = _shared(model, leaves)

    def layer(with_shared, x, scale, *leaves):
        scale, *leaves = cm.gather_layer(ds, mamba2.LAYER_KEYS,
                                         (scale, *leaves))
        p = dict(zip(mamba2.MIXER_KEYS, leaves))
        x = x + mamba2.block_fwd(p, cm.apply_norm(scale, x, cfg), cfg,
                                 backend=backend, tp=tp)
        if with_shared:
            x = shared_block_fwd(shared, x, emb, cfg, positions, tp)
        return x

    steps = [cm.maybe_remat(functools.partial(layer, w), cfg)
             for w in (False, True)]
    for i, (scale, p) in enumerate(mamba2._layers(model)):
        x = steps[_applies(cfg, i)](x, scale, *p.values())
    if last_only:
        x = x[:, -1:]
    x = cm.apply_norm(model.final_norm.scale, x, cfg)
    if hidden_only:
        return x
    return cm.logits_from_hidden(*cm.unembedding(model), x, cfg, tp=tp)


# --- decode ------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu", mp: int = 1,
               rank: int = 0) -> dict:
    """The decode cache, the JAX package's layout: ``{"mamba": {"conv":
    (L, B, S-1, conv_dim), "ssm": (L, B, H, N, P)}}`` in fp32 whatever
    ``dtype`` (``mamba2.init_cache``), and ``"k"``, ``"v"``: (n_app, B,
    max_len, KV, hd) in ``dtype``, one slot per application; zeros.
    ``mp`` and ``rank``: model rank ``rank`` of ``mp``'s, its SSM heads
    and conv channels and the shared block's KV heads of its head block
    (``sharding.head_blocks``)."""
    shape = (n_shared_applications(cfg), batch, max_len,
             len(sharding.head_blocks(cfg, mp)[rank][1]), cfg.head_dim)
    return {"mamba": mamba2.init_cache(cfg, batch, 0, torch.float32, device,
                                       mp),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def shared_block_decode(p: dict, x: torch.Tensor, emb: torch.Tensor, cfg,
                        ck: torch.Tensor, cv: torch.Tensor, pos: int,
                        tp=None) -> torch.Tensor:
    """The shared block on one token: x and emb (B, 1, D); ck and cv (B,
    Tmax, KV, hd) are this application's slot, into which k and v are
    written at ``pos`` (in place, in the cache's dtype); the query
    attends to positions 0..pos.  ``o @ wo`` promotes as JAX's matmul
    does (see ``common.attention_decode``).  With ``tp``, the rank's
    heads, as :func:`shared_block_fwd`."""
    B = x.shape[0]
    q, k, v = _shared_qkv(p, torch.cat([x, emb], dim=-1), cfg,
                          torch.full((B, 1), pos, device=x.device))
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    o = cm.gqa_attention(q, ck, cv, causal=False, kv_len=pos + 1)
    o = o.reshape(B, 1, -1)
    dt = torch.promote_types(o.dtype, p["wo"].dtype)
    x = x + cm.row_parallel(o.to(dt) @ p["wo"].to(dt), None, tp)
    return _mlp(p, x, cfg, tp)


def decode_step(model: Zamba2, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int at position ``pos`` (the K/V
    slots' valid length) -> (fp32 logits (B, 1, padded_vocab), cache),
    the cache updated in place.  A data rank's model (``model.ds``)
    gathers each Mamba2 layer's leaves where the layer runs, the
    embedding with the shared block's leaves once a step (as
    :func:`forward` does), and the unembedding where it is read."""
    cfg, tp = model.cfg, model.tp
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"position {pos} is past the cache's "
                         f"{cache['k'].shape[2]} slots")
    keys = ["embed.tok"] + [k for k, _ in model.named_parameters()
                            if k.startswith("shared.")]
    leaves = dict(zip(keys, cm.gathered(model, keys)))
    x = cm.embed_tokens(leaves["embed.tok"], tokens, cfg, tp=tp)
    emb = x
    shared = _shared(model, leaves)
    for i, (scale, p) in enumerate(mamba2._layers(model)):
        x = x + mamba2.layer_decode(model, scale, p, x, {
            k: v[i] for k, v in cache["mamba"].items()})
        if _applies(cfg, i):
            a = i // cfg.attn_every
            x = shared_block_decode(shared, x, emb, cfg, cache["k"][a],
                                    cache["v"][a], pos, tp)
    x = cm.apply_norm(model.final_norm.scale, x, cfg)
    return cm.logits_from_hidden(*cm.unembedding(model), x, cfg,
                                 tp=tp), cache
