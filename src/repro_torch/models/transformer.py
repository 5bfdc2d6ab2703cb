"""The decoder-only transformer LM, dense, MoE and VLM families
(counterpart of ``repro/models/transformer.py``: StarCoder2, Qwen2,
Qwen3; Moonlight, DeepSeek-V3; InternVL2).

Each layer is ``x + attn(norm(x))`` then ``x + ffn(norm(x))``, the FFN an
MLP or, in an MoE model's layers after its ``first_dense_layers``, the
MoE FFN (``models/moe.py``).  Attention is grouped-query attention with
rotary embeddings or, where ``cfg.mla`` is set, DeepSeek-V3's
Multi-head Latent Attention (``models/mla.py``), through the flash
kernels (``kernels/flash_attention.py``) when ``cfg.attn_impl ==
"flash"`` and through the plain chunked ``common.gqa_attention``
otherwise, as in the JAX package.

Parameters are kept as the JAX package keeps them: the per-layer leaves
stacked with a leading layer axis, under ``dense_layers`` (a dense
model's every layer, an MoE model's leading dense ones, whose MLP is
``d_ff_dense`` wide) and ``moe_layers`` (``moe_layers.moe.w_gate`` is
(L_moe, E, D, F)), so the state-dict keys, shapes and AdamW's ``ndim >=
2`` decay rule are the JAX tree's, and checkpoints cross between the
packages unchanged.  The forward takes each layer's slice through one
``unbind`` per stacked leaf (see ``models/mamba2.py``).  An MoE model's
``forward`` returns ``(logits, aux)``, aux the summed load-balance loss
of its MoE layers, as JAX's does; a dense model's returns the logits
(JAX's aux is 0 there).

Decode (``init_cache``, ``decode_step``) runs one token through every
layer against a KV cache of (L, B, Tmax, KV, hd) tensors a stack (an
MLA model's: the latent (L, B, Tmax, kv_lora) and the rotary key (L, B,
Tmax, rope)), updated in place; it runs no kernel
(``common.attention_decode``, ``mla.mla_attention_decode``, as in the
JAX package).

A VLM is the dense model behind a prefix: ``forward(...,
extra_embeds=)`` puts the (B, n_image_tokens, D) image embeddings,
cast to the model's dtype, before the token embeddings, and the rotary
positions and the causal mask run over the whole sequence.  Its decode
is the dense one over text tokens, as in the JAX package, whose serving
launcher decodes text only.

Tensor-parallel serving (the JAX launcher's ``--model-parallel``, where
GSPMD partitions the decode by ``models/sharding.py``'s rules): a model
built from a rank's blocks (``models.local_model``) with ``tp`` set to
its ``sharding.ModelGroup`` runs ``forward`` and ``decode_step``
on those blocks, the group's sums and gather where GSPMD inserts them
(``models/common.py``, ``moe.py``, ``mla.py``), and its fused prefill
runs ``flash_fwd`` on the rank's heads; its cache (``init_cache(...,
mp=, rank=)``) holds the KV heads its query heads read.  The heads are
``sharding.head_blocks``': where the KV heads do not divide over the
model axis, each is replicated on the ranks that split its group.  It
serves only: no gradient crosses the group.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.models import mla, moe, sharding

PREFIX = "dense_layers."
MOE_PREFIX = "moe_layers."
# the layer stacks (and Whisper's), whose leaves are drawn a layer's slab
# at a time; the MoE layers' expert leaves, a (layer, expert) slab at a
# time; any other leaf of more than SLAB values, in blocks of rows
STACKS = (PREFIX, MOE_PREFIX, "enc_layers.", "dec_layers.")
EXPERT_KEYS = tuple(f"{MOE_PREFIX}moe.{k}" for k in ("w_gate", "w_up",
                                                      "w_down"))
SLAB = 1 << 24


def norm_leaves(cfg) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """A norm's leaves, as ``common.attention_leaves``."""
    return {k: ((cfg.d_model,), "ones" if k == "scale" else "zeros", 0.0)
            for k in cm.init_norm(cfg, cfg.d_model, torch.float32)}


def layer_leaves(cfg, *, moe_layer: bool = False
                 ) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One layer's leaves without the leading ``L``: ``attn_norm``,
    ``attn`` (an MLA model's ``mla.mla_leaves``), ``mlp_norm`` and ``mlp``
    (an MoE model's dense layer: of ``d_ff_dense``), or ``moe`` in an MoE
    layer (``moe.moe_leaves``)."""
    norm = norm_leaves(cfg)
    layer = {f"attn_norm.{k}": v for k, v in norm.items()}
    attn = mla.mla_leaves(cfg) if cfg.mla else cm.attention_leaves(cfg)
    layer.update({f"attn.{k}": v for k, v in attn.items()})
    layer.update({f"mlp_norm.{k}": v for k, v in norm.items()})
    if moe_layer:
        layer.update({f"moe.{k}": v for k, v in moe.moe_leaves(cfg).items()})
    else:
        d_ff = cfg.d_ff if cfg.moe is None else cfg.moe.d_ff_dense
        layer.update({f"mlp.{k}": v
                      for k, v in cm.mlp_leaves(cfg, d_ff=d_ff).items()})
    return layer


def stacked_leaves(prefix: str, n: int, layer: dict) -> dict:
    """``layer``'s leaves under ``prefix``, each with a leading axis of
    ``n``."""
    return {prefix + k: ((n, *shape), *rest)
            for k, (shape, *rest) in layer.items()}


def stacks(cfg) -> list[tuple[str, int, bool]]:
    """The layer stacks in order: (prefix, layers, whether MoE); JAX's
    ``dense_layers`` then ``moe_layers``, each left out when empty."""
    n_dense = cfg.n_layers if cfg.moe is None else cfg.moe.first_dense_layers
    out = [(PREFIX, n_dense, False), (MOE_PREFIX, cfg.n_layers - n_dense,
                                      True)]
    return [s for s in out if s[1]]


def _leaf_spec(cfg) -> dict[str, tuple]:
    """Every leaf of the model: ``key -> (shape, init, scale[, dtype])``,
    the per-layer ones with their leading ``L``."""
    D = cfg.d_model
    spec = {f"embed.{k}": v for k, v in cm.embedding_leaves(cfg).items()}
    for prefix, n, moe_layer in stacks(cfg):
        spec.update(stacked_leaves(prefix, n,
                                   layer_leaves(cfg, moe_layer=moe_layer)))
    spec.update({f"final_norm.{k}": v for k, v in norm_leaves(cfg).items()})
    if not cfg.tie_embeddings:
        spec["unembed"] = ((D, cfg.padded_vocab), "normal", D ** -0.5)
    return spec


def _slabs(key: str, shape: tuple[int, ...]) -> list | None:
    """The indices of the slabs a leaf is drawn in, or None for a leaf
    drawn whole: a layer stack's leaf a layer at a time, an expert leaf
    (``EXPERT_KEYS``, (L, E, ...)) a (layer, expert) at a time, another
    leaf of more than ``SLAB`` values in blocks of rows of at most
    ``SLAB`` values."""
    if key in EXPERT_KEYS:
        return [(i, e) for i in range(shape[0]) for e in range(shape[1])]
    if key.startswith(STACKS):
        return list(range(shape[0]))
    row = math.prod(shape[1:])
    if row * shape[0] <= SLAB:
        return None
    rows = max(1, SLAB // row)
    return [slice(r, r + rows) for r in range(0, shape[0], rows)]


def draw_leaves(spec: dict, cfg, *, seed: int,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """``spec``'s leaves (``key -> (shape, init, scale[, dtype])``, the
    dtype defaulting to the config's) drawn on the host from ``seed`` and
    moved to ``device``.  A leaf drawn in slabs (``_slabs``: a layer
    stack's leaf a layer at a time, an expert leaf a (layer, expert) at a
    time, a large leaf such as the embedding in blocks of rows) takes
    each slab from a generator of its own, seeded from the model's
    generator in the spec's order, on up to 8 host threads, which start
    while the rest of the spec is read; the other leaves come whole from
    the model's generator.  The weights are a function of the seed alone,
    the same on every device whatever the threads' timing, and the host
    holds one fp32 slab a thread at most (a layer of DeepSeek-V3's dense
    MLP is 132 M values, 0.53 GB; an expert's 15 M): the host's normal
    draw is serial, about 120 M values a second a core."""
    gen = torch.Generator().manual_seed(seed)
    default = getattr(torch, cfg.dtype)
    leaves, jobs = {}, []

    def fill(slab, slab_seed, scale):
        g = torch.Generator().manual_seed(slab_seed)
        slab.copy_(torch.randn(slab.shape, generator=g).mul_(scale).to(
            slab.dtype))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for key, (shape, init, scale, *dt) in spec.items():
            dtype = getattr(torch, dt[0]) if dt else default
            slabs = _slabs(key, shape) if init == "normal" else None
            if init != "normal":
                leaves[key] = torch.full(shape, 1.0 if init == "ones" else 0.0,
                                         dtype=dtype, device=device)
            elif slabs is None:
                leaves[key] = (torch.randn(shape, generator=gen) * scale).to(
                    dtype).to(device)
            else:
                out = torch.empty(shape, dtype=dtype, device=device)
                seeds = torch.randint(0, 2 ** 62, (len(slabs),), generator=gen)
                jobs += [pool.submit(fill, out[i], s, scale)
                         for i, s in zip(slabs, seeds.tolist())]
                leaves[key] = out
        for job in jobs:  # reads every result: raises
            job.result()
    return leaves


class Transformer(nn.Module):
    """The language model; ``forward(tokens)`` is :func:`forward`.  Its
    parameters are the JAX tree's leaves under their dotted keys
    (``embed.tok``, ``dense_layers.attn.wq``, ``final_norm.scale``, ...).
    ``routing``: a ``moe.RoutingLog`` the MoE layers record their
    selection into (or replay it from), or None.  ``tp``: the
    ``sharding.ModelGroup`` of a tensor-parallel rank whose leaves are
    its blocks, or None."""

    routing: moe.RoutingLog | None = None
    tp = None
    # a data rank's sharding.DataShards (models.fsdp_model, local_model)
    ds = None
    # the data group whose global batch an MoE model's load-balance
    # statistics and capacity drops are taken over (an FSDP rank's, JAX's
    # sharded step's; a serving data row's where the batch is split)
    data_group = None
    # the experts a rank's (gathered) expert stacks hold, None for all
    expert_ids = None

    def __init__(self, cfg, leaves: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for key, t in leaves.items():
            *path, name = key.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(name, nn.Parameter(t))

    def forward(self, tokens: torch.Tensor, *,
                extra_embeds: torch.Tensor | None = None,
                last_only: bool = False,
                hidden_only: bool = False) -> torch.Tensor:
        return forward(self, tokens, extra_embeds=extra_embeds,
                       last_only=last_only, hidden_only=hidden_only)


def init_params(cfg, *, seed: int = 0,
                device: torch.device | str = "cpu") -> Transformer:
    """The model with weights drawn on the host from a generator seeded
    with ``seed`` (the same weights on every device), each leaf moved to
    ``device`` as it is drawn, by the JAX package's distributions: normal
    projections scaled by fan-in ** -0.5, embeddings by 0.02, zero biases,
    unit norm scales; an MoE model's router in fp32 (``draw_leaves``)."""
    _check_family(cfg)
    return Transformer(cfg, draw_leaves(_leaf_spec(cfg), cfg, seed=seed,
                                        device=device))


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the transformer builds the dense, MoE and VLM "
                         f"families, not {cfg.family!r}")


def _nest(keys: list[str], values) -> dict:
    """``["attn.wq", "moe.shared.w_up", ...]`` and their tensors ->
    ``{"attn": {"wq": ...}, "moe": {"shared": {"w_up": ...}}}``."""
    out: dict = {}
    for key, t in zip(keys, values):
        *path, name = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = t
    return out


def _attn_half(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``x + attn(norm(x))`` and its FFN's input, ``norm`` of it."""
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    if cfg.mla:
        x = x + mla.mla_attention_block(lp["attn"], h, cfg, positions, tp=tp)
    else:
        x = x + cm.attention_block(lp["attn"], h, cfg, positions, tp=tp)
    return x, cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                            lp["mlp_norm"].get("bias"))


def _layer_fwd(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               tp=None) -> torch.Tensor:
    x, h = _attn_half(lp, x, cfg, positions, tp)
    return x + cm.apply_mlp(lp["mlp"], h, cfg, tp=tp)


def _moe_layer_fwd(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                   routing, layer: int, tp=None, data_group=None,
                   experts=None) -> tuple[torch.Tensor, torch.Tensor]:
    x, h = _attn_half(lp, x, cfg, positions, tp)
    o, aux = moe.moe_ffn(lp["moe"], h, cfg, routing=routing, layer=layer,
                         tp=tp, data_group=data_group, experts=experts)
    return x + o, aux


def _stacked(model: nn.Module, prefix: str = PREFIX
             ) -> tuple[list[str], list[torch.Tensor]]:
    """The per-layer leaves' keys below ``prefix`` and their stacked
    tensors."""
    pairs = [(k[len(prefix):], p) for k, p in model.named_parameters()
             if k.startswith(prefix)]
    return [k for k, _ in pairs], [p for _, p in pairs]


def _final(model: nn.Module, x: torch.Tensor, hidden_only: bool = False,
           tok: torch.Tensor | None = None) -> torch.Tensor:
    """The final norm, then the logits unless ``hidden_only`` (``tok``:
    the embedding table the forward read, gathered on an FSDP rank)."""
    cfg = model.cfg
    fn = model.final_norm
    x = cm.apply_norm(fn.scale, x, cfg, getattr(fn, "bias", None))
    if hidden_only:
        return x
    return cm.logits_from_hidden(*cm.unembedding(model, tok), x, cfg,
                                 tp=model.tp)


def forward(model: Transformer, tokens: torch.Tensor, *,
            extra_embeds: torch.Tensor | None = None,
            last_only: bool = False, hidden_only: bool = False):
    """tokens (B, T) int -> fp32 logits (B, T, padded_vocab), the padded
    columns at ``common.NEG_INF``; for the MoE family ``(logits, aux)``,
    aux the MoE layers' load-balance losses summed (0-d fp32).
    ``extra_embeds`` (B, T_img, D), a VLM's image embeddings, go before
    the token embeddings in the model's dtype: the output then covers
    T_img + T positions, the rotary positions 0..T_img + T - 1.
    ``last_only`` keeps the last position only (B, 1, ...);
    ``hidden_only`` returns the final-normed hidden state instead of
    logits.  With ``cfg.remat`` each layer's activations are recomputed
    in the backward.  The MoE layers record into ``model.routing``.  A
    tensor-parallel rank's model (``model.tp``) runs its blocks; an FSDP
    rank's (``model.ds``) gathers each layer's leaves inside the layer
    (``common.gather_layer``) and the embedding where it is read."""
    cfg = model.cfg
    tp, ds = model.tp, model.ds
    tok, = cm.gathered(model, ["embed.tok"])
    x = cm.embed_tokens(tok, tokens, cfg, tp=tp)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=tokens.device)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if cfg.family == "moe" else None)
    first = 0  # the stack's first layer, counted over both stacks
    for prefix, n, moe_layer in stacks(cfg):
        keys, stacked = _stacked(model, prefix)
        full = [prefix + k for k in keys]
        # keys and the layer's index bound now: remat calls the layer
        # again in the backward, after the loop has moved on
        for i, lp in enumerate(zip(*(p.unbind(0) for p in stacked))):
            if moe_layer:
                def layer(x, *leaves, keys=keys, full=full, i=first + i):
                    leaves = cm.gather_layer(ds, full, leaves)
                    return _moe_layer_fwd(_nest(keys, leaves), x, cfg,
                                          positions, model.routing, i, tp,
                                          model.data_group, model.expert_ids)
                x, a = cm.maybe_remat(layer, cfg)(x, *lp)
                aux = aux + a
            else:
                def layer(x, *leaves, keys=keys, full=full):
                    leaves = cm.gather_layer(ds, full, leaves)
                    return _layer_fwd(_nest(keys, leaves), x, cfg, positions,
                                      tp)
                x = cm.maybe_remat(layer, cfg)(x, *lp)
        first += n
    if last_only:
        x = x[:, -1:]
    out = _final(model, x, hidden_only, tok)
    return (out, aux) if cfg.family == "moe" else out


# --- decode (KV cache) ---------------------------------------------------------

_CACHE_OF = {PREFIX: "dense", MOE_PREFIX: "moe"}


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu", mp: int = 1,
               rank: int = 0) -> dict:
    """The KV cache, the JAX package's layout: a stack's ``{"k": (L, B,
    max_len, KV, hd), "v": (...)}`` (an MLA model's ``{"c_kv": (L, B,
    max_len, kv_lora), "k_rope": (L, B, max_len, rope)}``) in ``dtype``,
    zeros, under ``"dense"`` and (an MoE model's) ``"moe"``.  ``mp`` and
    ``rank``: model rank ``rank`` of ``mp``'s cache, the KV heads of its
    head block (``sharding.head_blocks``: KV/mp where they divide, the
    one KV head it shares with mp/KV ranks where mp divides over them);
    an MLA model's latent stays whole (``models/mla.py``)."""
    _check_family(cfg)
    if cfg.mla:
        return {_CACHE_OF[prefix]: mla.mla_init_cache(
            cfg, batch, max_len, dtype, device, layers=n)
            for prefix, n, _ in stacks(cfg)}
    kv = len(sharding.head_blocks(cfg, mp)[rank][1])
    shape = (batch, max_len, kv, cfg.head_dim)
    return {_CACHE_OF[prefix]: {
        k: torch.zeros((n, *shape), dtype=dtype, device=device)
        for k in ("k", "v")} for prefix, n, _ in stacks(cfg)}


def _layer_decode(lp: dict, x: torch.Tensor, cfg, layer_cache: dict,
                  pos: int, routing=None, layer: int = 0,
                  absorb: bool = False, tp=None, data_group=None,
                  experts=None) -> torch.Tensor:
    h = cm.apply_norm(lp["attn_norm"]["scale"], x, cfg,
                      lp["attn_norm"].get("bias"))
    if cfg.mla:
        x = x + mla.mla_attention_decode(lp["attn"], h, cfg, layer_cache,
                                         pos, absorb=absorb, tp=tp)
    else:
        x = x + cm.attention_decode(lp["attn"], h, cfg, layer_cache["k"],
                                    layer_cache["v"], pos, tp=tp)
    h = cm.apply_norm(lp["mlp_norm"]["scale"], x, cfg,
                      lp["mlp_norm"].get("bias"))
    if "moe" in lp:
        o, _ = moe.moe_ffn(lp["moe"], h, cfg, routing=routing, layer=layer,
                           pos=pos, tp=tp, data_group=data_group,
                           experts=experts, want_aux=False)
        return x + o
    return x + cm.apply_mlp(lp["mlp"], h, cfg, tp=tp)


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos: int, *, absorb: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int at position ``pos`` (the
    cache's valid length) -> (fp32 logits (B, 1, padded_vocab), cache),
    each layer's k and v (an MLA model's latent and rotary key) written
    into the cache at ``pos`` in place; the MoE layers record into
    ``model.routing`` (at position ``pos``).  ``absorb`` takes an MLA
    model's absorbed decode (``mla.mla_attention_decode``); the other
    models ignore it, as JAX's do.  A data rank's model (``model.ds``)
    gathers each layer's leaves, and the tables, where they are read."""
    cfg = model.cfg
    _check_family(cfg)
    slots = next(iter(next(iter(cache.values())).values())).shape[2]
    if pos >= slots:
        raise ValueError(f"position {pos} is past the cache's {slots} "
                         "slots")
    tok, = cm.gathered(model, ["embed.tok"])
    x = cm.embed_tokens(tok, tokens, cfg, tp=model.tp)
    first = 0
    for prefix, n, _ in stacks(cfg):
        keys, stacked = _stacked(model, prefix)
        full = [prefix + k for k in keys]
        c = cache[_CACHE_OF[prefix]]
        layer_caches = [dict(zip(c, slices)) for slices in
                        zip(*(t.unbind(0) for t in c.values()))]
        for i, (lp, lc) in enumerate(zip(
                zip(*(p.unbind(0) for p in stacked)), layer_caches)):
            lp = cm.gather_layer(model.ds, full, lp)
            x = _layer_decode(_nest(keys, lp), x, cfg, lc, pos,
                              model.routing, first + i, absorb, model.tp,
                              model.data_group, model.expert_ids)
        first += n
    return _final(model, x, tok=tok), cache
